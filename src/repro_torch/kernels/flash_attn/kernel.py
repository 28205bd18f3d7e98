"""Wrapper around the Hopper flash-attention kernel in
``csrc/flash_attn.cu``.

It replaces the TPU kernel ``src/repro/kernels/flash_attn/kernel.py``
(``flash_attention``, body ``_flash_kernel``).  The wrapper checks device,
dtype, shape, head dim and contiguity, allocates the output with
``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, counts the launch, and raises if the entry point reports a
CUDA error.  CUDA tensors only: the plain version lives in ``ref.py``.
The kernel's own tiles are 64 x 64; it takes any S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must share one (B, H, S, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} is not "
                         f"one the CUDA kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned (make the (B,S,H,D) -> "
                             "(B,H,S,D) transpose contiguous first)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q/k/v: (B, H, S, D) on the card -> (B, H, S, D) in q's dtype."""
    _check(q, k, v, window)
    b, h, s, d = q.shape
    lib = build.load()
    out = torch.empty_like(q)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s,
        d, _DTYPES[q.dtype], int(causal), window or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    build.bump("flash_attention")
    return out
