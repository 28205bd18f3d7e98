"""Public fused Adam op with padding to the tile: the device decides.

A CUDA tensor takes the Hopper kernel (``kernel.py``), a CPU tensor the
plain version (``ref.py``); a meta tensor (the dry run) gets empty outputs
and counts a launch, computing nothing; any other device raises.  As the reference's
wrapper (``src/repro/kernels/fused_adam/ops.py``), vectors are padded
with zeros to a multiple of ``tile`` and the result is cut back to ``d``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_adam import kernel as K
from repro_torch.kernels.fused_adam import ref as R
from repro_torch.perf import kernel_cost

DEFAULT_TILE = 8192


def adam_step(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0, tile: int = DEFAULT_TILE
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused BertAdam step on flat f32 vectors; pads to the tile size."""
    if x.is_meta:
        build.meta_launch("adam_step", kernel_cost.adam_update_cost(
            x.shape[0] + (-x.shape[0]) % tile, fused=True))
        return tuple(torch.empty_like(x) for _ in range(3))
    if x.is_cuda:
        step = K.adam_step
    elif x.device.type == "cpu":
        step = R.adam_step
    else:
        raise ValueError(f"no fused Adam path for device {x.device}")
    d = x.shape[0]
    pad = (-d) % tile
    if pad:
        z = torch.zeros(pad, dtype=torch.float32, device=x.device)
        x, m, v, g = (torch.cat([a, z]) for a in (x, m, v, g))
    nx, nm, nv = step(x, m, v, g, lr, b1, b2, eps, weight_decay)
    if pad:
        nx, nm, nv = nx[:d], nm[:d], nv[:d]
    return nx, nm, nv
