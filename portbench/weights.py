"""The benchmark's weights: the global float32 parameters made on the
device from the seed, in one draw.

One ``torch.randn`` over every parameter from a ``torch.Generator`` on
the device, then each leaf scaled by its law, as the program's own
initialiser scales it: the norm scales 1, the embedding N(0, 0.02^2),
every other weight N(0, 1 / fan_in) with fan_in the leaf's second-to-last
dim.  The same seed gives the same weights to the program and to the
reference.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import transformer


def global_params(cfg: dict, seed: int, device, tp: int = 1,
                  ref=transformer) -> torch.Tensor:
    """The flat float32 vector of the global leaves at ``tp`` of the
    reference module ``ref`` (whose ``leaves`` give each leaf's shape and
    law)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(ref.n_params(cfg, tp), generator=gen, device=device,
                       dtype=torch.float32)
    off = 0
    with torch.no_grad():
        for lf in ref.leaves(cfg, tp):
            n = math.prod(lf.shape)
            seg = flat[off:off + n]
            if lf.init == "ones":
                seg.fill_(1.0)
            elif lf.init == "embed":
                seg.mul_(0.02)
            else:
                seg.mul_(lf.shape[-2] ** -0.5)
            off += n
    return flat
