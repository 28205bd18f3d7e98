"""Plain PyTorch version of the fused Adam kernel (warmup-stage hot path).

The operations run in the order of the TPU kernel body
(``src/repro/kernels/fused_adam/kernel.py:_adam_kernel``), each rounded
on its own, so the CUDA kernel (``csrc/fused_adam.cu``) matches it
operation for operation.  Python scalars meet the f32 tensors as f32, as
they do in JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch


def adam_step(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, lr: float, b1: float, b2: float, eps: float,
              weight_decay: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BertAdam step (no bias correction). Returns (new_x, new_m, new_v)."""
    new_m = b1 * m + (1.0 - b1) * g
    new_v = b2 * v + (1.0 - b2) * g * g
    upd = new_m / (torch.sqrt(new_v) + eps)
    if weight_decay:
        upd = upd + weight_decay * x
    return x - lr * upd, new_m, new_v
