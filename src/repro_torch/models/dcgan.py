"""Small DCGAN (paper Sec. 7.3): a conv-transpose generator and a conv
discriminator, GroupNorm (4 groups) in place of BatchNorm (stateless; the
ResNet testbed's deviation, which leaves the optimizer behaviour under
study unchanged).

The port of ``repro/models/dcgan.py``.  Parameters are ``{dotted path:
f32 tensor}`` with the reference's leaves in its layout (HWIO kernels);
images are NHWC.  Two layout points of the reference are kept: the
generator's first activation is the dense output read as NHWC, and the
discriminator's head flattens its last map in NHWC order.  The
generator's deconvs are the reference's unflipped ``conv_transpose``
(``_deconv``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import conv_same, group_norm

Params = Dict[str, torch.Tensor]
GROUPS = 4
BASE = 32


def _w(gen: torch.Generator, k: int, cin: int, cout: int) -> torch.Tensor:
    return torch.randn((k, k, cin, cout), generator=gen) * 0.05


def _deconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NCHW counterpart of the reference's 4 x 4 stride-2 ``_deconv``
    (``lax.conv_transpose``, SAME): a correlation of the stride-dilated
    input with ``w`` as it stands (no flip, no in/out swap).
    ``F.conv_transpose2d`` is the adjoint of ``conv2d``, which correlates
    with the flipped kernel, so the weight goes in flipped, laid out (I, O,
    kH, kW); SAME pads the dilated input (2, 2), which is padding 1."""
    return F.conv_transpose2d(x, torch.flip(w, (0, 1)).permute(2, 3, 0, 1),
                              stride=2, padding=1)


def init_generator(gen: torch.Generator, z_dim: int = 32, base: int = BASE,
                   device="cpu") -> Params:
    p = {"fc": torch.randn((z_dim, 4 * 4 * base * 2), generator=gen) * 0.05,
         "d1": _w(gen, 4, base * 2, base),        # 4->8
         "s1": torch.ones(base), "b1": torch.zeros(base),
         "d2": _w(gen, 4, base, 3)}               # 8->16
    return {k: v.to(device) for k, v in p.items()}


def generator(p: Params, z: torch.Tensor, base: int = BASE) -> torch.Tensor:
    """z: (N, z_dim) -> images (N, 16, 16, 3) in [-1, 1]."""
    # contiguous NCHW copies of the NHWC views, as resnet_apply's input
    h = F.relu((z @ p["fc"]).reshape(-1, 4, 4, base * 2)).permute(
        0, 3, 1, 2).contiguous()
    h = F.relu(group_norm(_deconv(h, p["d1"]), p["s1"],
                          p["b1"], GROUPS))
    return torch.tanh(_deconv(h, p["d2"])).permute(0, 2, 3, 1)


def init_discriminator(gen: torch.Generator, base: int = BASE,
                       device="cpu") -> Params:
    p = {"c1": _w(gen, 4, 3, base),               # 16->8
         "c2": _w(gen, 4, base, base * 2),        # 8->4
         "s2": torch.ones(base * 2), "b2": torch.zeros(base * 2),
         "fc": torch.randn((4 * 4 * base * 2, 1), generator=gen) * 0.05}
    return {k: v.to(device) for k, v in p.items()}


def discriminator(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 16, 16, 3) -> logits (N,)."""
    h = F.leaky_relu(conv_same(x.permute(0, 3, 1, 2).contiguous(), p["c1"],
                               2), 0.2)
    h = F.leaky_relu(group_norm(conv_same(h, p["c2"], 2), p["s2"], p["b2"],
                                GROUPS), 0.2)
    return (h.permute(0, 2, 3, 1).reshape(h.shape[0], -1) @ p["fc"])[:, 0]


def d_loss(pd: Params, pg: Params, real: torch.Tensor, z: torch.Tensor
           ) -> torch.Tensor:
    """Non-saturating GAN losses (the DCGAN paper's objective); no
    gradient flows into the generator."""
    fake = generator(pg, z).detach()
    return (F.softplus(-discriminator(pd, real)).mean()
            + F.softplus(discriminator(pd, fake)).mean())


def g_loss(pg: Params, pd: Params, z: torch.Tensor) -> torch.Tensor:
    return F.softplus(-discriminator(pd, generator(pg, z))).mean()


def synthetic_faces(rng: np.random.Generator, n: int, size: int = 16,
                    device="cpu") -> torch.Tensor:
    """Structured 'face-like' targets: smooth radial blobs with per-sample
    position/colour variation (enough structure for a GAN to learn),
    (n, size, size, 3) in [-1, 1]; centres and colours from ``rng``."""
    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    cx = uniform(0.3, 0.7, (n, 1, 1, 1))
    cy = uniform(0.3, 0.7, (n, 1, 1, 1))
    col = uniform(-0.8, 0.8, (n, 1, 1, 3))
    yy, xx = torch.meshgrid(torch.arange(size) / size,
                            torch.arange(size) / size, indexing="ij")
    r2 = (xx[None, :, :, None] - cx) ** 2 + (yy[None, :, :, None] - cy) ** 2
    return torch.clamp(col * torch.exp(-r2 * 20.0) * 2.0 - 0.2, -1,
                       1).to(device)
