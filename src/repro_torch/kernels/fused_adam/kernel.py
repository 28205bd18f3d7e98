"""Wrapper around the Hopper fused Adam kernel in ``csrc/fused_adam.cu``.

It replaces the TPU kernel ``src/repro/kernels/fused_adam/kernel.py``
(``adam_step``).  The wrapper checks device, dtype, contiguity, shapes
and alignment, allocates the three outputs with ``torch.empty``, launches
on ``torch.cuda.current_stream()`` without synchronising, counts the
launch, and raises if the entry point reports a CUDA error.  CUDA
tensors only: the plain version lives in ``ref.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build


def adam_step(x: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused BertAdam step on flat (d,) f32 CUDA vectors, d % 4 == 0."""
    d = x.shape[0] if x.ndim == 1 else -1
    for name, t in (("x", x), ("m", m), ("v", v), ("g", g)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or t.ndim != 1 or t.shape[0] != d:
            raise ValueError(f"{name}: expected float32 ({d},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             "aligned tensor (float4 accesses)")
    if d % 4:
        raise ValueError(f"length {d} is not a multiple of 4 (float4 "
                         "accesses; ops.adam_step pads to the tile)")
    lib = build.load()
    nx, nm, nv = (torch.empty_like(x) for _ in range(3))

    def f32(a: float) -> float:   # the f32 value the reference's scalar takes
        return float(np.float32(a))

    rc = lib.repro_adam_step(
        x.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
        nx.data_ptr(), nm.data_ptr(), nv.data_ptr(), d,
        f32(lr), f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps),
        f32(weight_decay), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "adam_step")
    build.bump("adam_step")
    return nx, nm, nv
