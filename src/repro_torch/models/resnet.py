"""Small CIFAR ResNet (the paper's Sec. 7.2 / supplementary
optimizer-comparison testbed).

The port of ``repro/models/resnet.py``, with its deviations from the
paper's ResNet-18: one basic block a stage (depth set by ``widths``),
GroupNorm (8 groups) in place of BatchNorm (stateless).  Neither changes
the optimizer-communication behaviour under study.

Parameters are ``{dotted path: f32 tensor}`` (``b0.c1``, ``fc``, ...),
each leaf in the reference's layout (conv weights HWIO), so
``convert.flat_from_params`` lays them out in ``ravel_pytree``'s order
and every compression block covers the reference's elements.  Images are
NHWC, as the reference's; the convs run in NCHW (``common.conv_same``
pads as XLA's SAME does).  Random draws come from an explicit
``torch.Generator`` and a numpy ``Generator``; parity tests feed the
reference's arrays.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import conv_same, group_norm

Params = Dict[str, torch.Tensor]
WIDTHS = (16, 32, 64)
GROUPS = 8


def _init_conv(gen: torch.Generator, k: int, cin: int, cout: int
               ) -> torch.Tensor:
    fan = k * k * cin
    return torch.randn((k, k, cin, cout), generator=gen) * (2.0 / fan) ** 0.5


def init_resnet(gen: torch.Generator, widths: Sequence[int] = WIDTHS,
                n_classes: int = 10, in_ch: int = 3, device="cpu"
                ) -> Params:
    """He-normal convs, unit scales, zero biases, N(0, 1/c) head; drawn on
    the CPU from ``gen`` and moved to ``device``."""
    p: Params = {"stem": _init_conv(gen, 3, in_ch, widths[0]),
                 "stem_s": torch.ones(widths[0]),
                 "stem_b": torch.zeros(widths[0])}
    cin = widths[0]
    for i, cout in enumerate(widths):
        p[f"b{i}.c1"] = _init_conv(gen, 3, cin, cout)
        p[f"b{i}.s1"], p[f"b{i}.g1"] = torch.ones(cout), torch.zeros(cout)
        p[f"b{i}.c2"] = _init_conv(gen, 3, cout, cout)
        p[f"b{i}.s2"], p[f"b{i}.g2"] = torch.ones(cout), torch.zeros(cout)
        p[f"b{i}.sc"] = _init_conv(gen, 1, cin, cout)
        cin = cout
    p["fc"] = torch.randn((cin, n_classes), generator=gen) * (1 / cin) ** 0.5
    p["fc_b"] = torch.zeros(n_classes)
    return {k: v.to(device) for k, v in p.items()}


def resnet_apply(p: Params, x: torch.Tensor,
                 widths: Sequence[int] = WIDTHS) -> torch.Tensor:
    """x: (N, H, W, C) -> logits (N, n_classes)."""
    # a contiguous NCHW copy: torch's CPU (oneDNN) conv backward has
    # corrupted the heap on the channels-last strides of the permuted view
    h = x.permute(0, 3, 1, 2).contiguous()
    h = F.relu(group_norm(conv_same(h, p["stem"]), p["stem_s"],
                          p["stem_b"], GROUPS))
    for i in range(len(widths)):
        stride = 1 if i == 0 else 2
        y = F.relu(group_norm(conv_same(h, p[f"b{i}.c1"], stride),
                              p[f"b{i}.s1"], p[f"b{i}.g1"], GROUPS))
        y = group_norm(conv_same(y, p[f"b{i}.c2"]), p[f"b{i}.s2"],
                       p[f"b{i}.g2"], GROUPS)
        h = F.relu(y + conv_same(h, p[f"b{i}.sc"], stride))
    return h.mean(dim=(2, 3)) @ p["fc"] + p["fc_b"]


def resnet_loss(p: Params, batch: Dict[str, torch.Tensor],
                widths: Sequence[int] = WIDTHS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean cross entropy, accuracy) of one batch."""
    logits = resnet_apply(p, batch["images"], widths)
    labels = batch["labels"]
    nll = -torch.gather(F.log_softmax(logits, -1), 1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll.mean(), acc


def synthetic_cifar(rng: np.random.Generator, n: int, n_classes: int = 10,
                    size: int = 16, device="cpu") -> Dict[str, torch.Tensor]:
    """Learnable synthetic image task: class-dependent frequency patterns
    + noise (a stand-in for CIFAR-10; optimizers separate on it).  The
    patterns are the reference's; labels and noise come from ``rng``."""
    labels = torch.from_numpy(rng.integers(0, n_classes, n))
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size),
                            indexing="ij")
    freqs = torch.arange(1, n_classes + 1)[:, None, None]
    pattern = torch.sin((freqs * xx) * 0.4 + ((freqs % 3) * yy) * 0.5)
    base = pattern[labels][..., None].expand(n, size, size, 3)
    noise = 0.8 * torch.from_numpy(
        rng.standard_normal((n, size, size, 3), dtype=np.float32))
    return {"images": (base + noise).to(device=device, dtype=torch.float32),
            "labels": labels.to(device)}
