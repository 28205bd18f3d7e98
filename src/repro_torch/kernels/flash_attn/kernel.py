"""Wrappers around the Hopper flash-attention kernels.

Both replace the TPU kernel ``src/repro/kernels/flash_attn/kernel.py``
(``flash_attention``, body ``_flash_kernel``).  The route is decided by
dtype alone, never by a failure:

* bf16 and fp16 take the tensor-core kernel (``csrc/flash_attn_sm90.cu``:
  wgmma + TMA, counted as ``flash_attention_wgmma``);
* f32 takes the exact SIMT kernel (``csrc/flash_attn.cu``, counted as
  ``flash_attention``).

Any head dim 1 <= D <= 256 is taken: a D that a kernel has no instance
for is zero-padded on the card to the next instantiated one, the kernel
scales the scores by the true D, and the output is sliced back (zero
columns leave q.k unchanged; zero v columns give output columns that are
dropped).  The wrapper checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on
``torch.cuda.current_stream()`` without synchronising, counts the launch,
and raises if the entry point reports a CUDA error.  CUDA tensors only:
the plain version lives in ``ref.py``.  Both kernels take any S.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
# head dims each kernel has an instance for
SIMT_HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The instantiated head dim that a (., ., ., d) input of ``dtype`` is
    zero-padded to: the smallest one >= d of the kernel its dtype routes
    to."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside the "
                         f"kernels' 1..{MAX_HEAD_DIM}")
    dims = WGMMA_HEAD_DIMS if dtype in _WGMMA_DTYPES else SIMT_HEAD_DIMS
    return next(x for x in dims if x >= d)


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


_run_simt = _launcher("repro_flash_attention", _SIMT_DTYPES,
                      "flash_attention")
_run_wgmma = _launcher("repro_flash_attention_wgmma", _WGMMA_DTYPES,
                       "flash_attention_wgmma")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q/k/v: (B, H, S, D) on the card -> (B, H, S, D) in q's dtype.
    bf16 and fp16 take the tensor-core kernel, f32 the SIMT kernel."""
    if q.dtype in _WGMMA_DTYPES:
        _check(q, k, v, window, _WGMMA_DTYPES)
        return with_padded_head_dim(_run_wgmma, q, k, v, causal, window)
    _check(q, k, v, window, _SIMT_DTYPES)
    return with_padded_head_dim(_run_simt, q, k, v, causal, window)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None
                         ) -> torch.Tensor:
    """The SIMT kernel on f32 or bf16, whatever the route: for timing the
    two kernels on the same bf16 inputs.  No model path calls it."""
    _check(q, k, v, window, _SIMT_DTYPES)
    return with_padded_head_dim(_run_simt, q, k, v, causal, window)
