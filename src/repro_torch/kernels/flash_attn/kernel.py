"""Wrappers around the Hopper flash-attention kernels.

Every route replaces the TPU kernel ``src/repro/kernels/flash_attn/kernel.py``
(``flash_attention``, body ``_flash_kernel``) and runs on the tensor cores
(wgmma).  The route is decided by dtype and head dim alone, never by a
failure:

* bf16 and fp16 with head dims 1..256: the wgmma + TMA kernel
  (``csrc/flash_attn_sm90.cu`` ``repro_flash_attention_wgmma``, counted as
  ``flash_attention_wgmma``);
* f32 with head dims 1..256: the split kernel
  (``csrc/flash_attn_sm90_split.cu`` ``repro_flash_attention``, counted as
  ``flash_attention``), which runs each f32 product as six bf16 products
  of three-term splits and keeps f32 accuracy;
* head dims above 256, in f32, bf16 and fp16: the same split kernel, one
  CTA per 128 query rows (two warpgroups of 64) and output slice of 128
  (f32) or 256 (16-bit) columns (``repro_flash_attention_wide``, counted as
  ``flash_attention_wide``).  No configuration has D > 128; it is there so
  the wrappers take every D the reference takes.

A D that a kernel has no instance for is zero-padded on the card to the
next instantiated one (64/128/256 for the wgmma kernel, a multiple of 64
for the split kernel), the kernel scales the scores by the true D, and the
output is sliced back (zero columns leave q.k unchanged; zero v columns
give output columns that are dropped).  The wrapper checks device, dtype,
shape and contiguity, allocates the output with ``torch.empty``, launches
on ``torch.cuda.current_stream()`` without synchronising, counts the
launch, and raises if the entry point reports a CUDA error.  CUDA tensors
only: the plain version lives in ``ref.py``.  Every kernel takes any S.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# head dims the wgmma kernel has an instance for (16-bit, D <= MAX_HEAD_DIM);
# the split kernel takes any multiple of SPLIT_CHUNK (f32, and every dtype
# above MAX_HEAD_DIM)
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)
SPLIT_CHUNK = 64
_F32_DTYPES = {torch.float32: 0}
_WGMMA_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
_WIDE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The instantiated head dim that a (., ., ., d) input of ``dtype`` is
    zero-padded to: the smallest one >= d of the kernel it routes to."""
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} must be >= 1")
    if d > MAX_HEAD_DIM or dtype not in _WGMMA_DTYPES:
        return -(-d // SPLIT_CHUNK) * SPLIT_CHUNK
    return next(x for x in WGMMA_HEAD_DIMS if x >= d)


def with_padded_head_dim(fn: Callable[..., torch.Tensor], q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, causal: bool,
                         window: Optional[int]) -> torch.Tensor:
    """``fn(q, k, v, causal, window, head_dim)`` on q, k, v zero-padded to
    :func:`kernel_head_dim`, with ``head_dim`` the true D (the score
    scale), and its output sliced back to D columns."""
    d = q.shape[-1]
    dk = kernel_head_dim(d, q.dtype)
    if dk == d:
        return fn(q, k, v, causal, window, d)
    q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    return fn(q, k, v, causal, window, d)[..., :d].contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], dtypes) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must share one (B, H, S, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kernel_head_dim(q.shape[-1], q.dtype)
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype of "
                         f"{tuple(dtypes)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
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


def _launcher(entry: str, dtypes, counter: str):
    def run(q, k, v, causal, window, head_dim):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        rc = getattr(build.load(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            s, d, head_dim, dtypes[q.dtype], int(causal), window or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, counter)
        build.bump(counter)
        return out
    return run


_run_f32 = _launcher("repro_flash_attention", _F32_DTYPES, "flash_attention")
_run_wide = _launcher("repro_flash_attention_wide", _WIDE_DTYPES,
                      "flash_attention_wide")
_run_wgmma = _launcher("repro_flash_attention_wgmma", _WGMMA_DTYPES,
                       "flash_attention_wgmma")


def route(q: torch.Tensor) -> str:
    """The launch counter of the kernel a query of q's dtype and head dim
    routes to (:func:`flash_attention`)."""
    if q.shape[-1] > MAX_HEAD_DIM:
        return "flash_attention_wide"
    if q.dtype in _WGMMA_DTYPES:
        return "flash_attention_wgmma"
    return "flash_attention"


# each route's counter -> (the dtypes it takes, its launcher)
_ROUTES = {"flash_attention_wide": (_WIDE_DTYPES, _run_wide),
           "flash_attention_wgmma": (_WGMMA_DTYPES, _run_wgmma),
           "flash_attention": (_F32_DTYPES, _run_f32)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q/k/v: (B, H, S, D) on the card -> (B, H, S, D) in q's dtype.
    D <= 256: bf16 and fp16 take the wgmma kernel, f32 the split kernel;
    D > 256 takes the split kernel's wide route in every dtype."""
    dtypes, run = _ROUTES[route(q)]
    _check(q, k, v, window, dtypes)
    return with_padded_head_dim(run, q, k, v, causal, window)
