"""Wrappers around the dispatch kernels in ``csrc/moe_dispatch.cu``.

They replace no TPU kernel: the reference's MoE layer has a capacity and
dispatches by one-hot matmuls or by XLA's gather and scatter.  The
dropless layer (``models.mlp.dropless_moe_forward``) routes a
data-dependent number of rows to each held expert, and torch's own
scatter-add (``index_add``) sums them with float atomics, in an order that
changes from run to run.  These kernels move the rows by index and sum
each token's rows in choice order, with float32 accumulation: no float
atomics, no host sync, bitwise the same from run to run.

``moe_permute`` and ``moe_combine`` are one entry each for both
directions, so a launch spy sees every launch of the family:

* ``moe_permute(x, pair, k)``: (R, d) rows, row r token ``pair[r] // k``'s
  row of x, rows with ``pair`` -1 left unwritten; ``backward=True``:
  ``moe_permute(dxp, slot, k, backward=True)`` gives (T, d), each token's
  rows of dxp named by ``slot`` (T, k) summed;
* ``moe_combine(ye, g, slot, k)``: (T, d), y[t] = sum_j g[t, j]
  ye[slot[t, j]]; with ``dy`` given, ``moe_combine(ye, g, pair, k, dy=dy)``
  gives (dye (R, d), dg (T, k)): dye[r] = g[pair[r]] dy[t], an empty row
  left unwritten, and dg = <dy[t], ye[r]> (0 where not held).

The wrappers check device, dtype (bf16 or f32 rows, f32 gates, int32
indices), contiguity and shapes, allocate the outputs with ``torch.empty``
(dg with ``torch.zeros``), launch on ``torch.cuda.current_stream()``
without synchronising, count one ``moe_permute`` / ``moe_combine`` launch
each, and raise if the entry point reports a CUDA error.  CUDA tensors
only: the plain version lives in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build

_ESIZE = {torch.bfloat16: 2, torch.float32: 4}


def _rows(name: str, t: torch.Tensor, n: Optional[int] = None) -> None:
    if not t.is_cuda or t.dtype not in _ESIZE or t.ndim != 2 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D bf16 or f32 "
                         f"CUDA tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if (t.shape[1] * t.element_size()) % 16:
        raise ValueError(f"{name}: a row of {t.shape[1]} elements is not a "
                         "multiple of 16 bytes")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected {n} rows, got {t.shape[0]}")


def _index(name: str, t: torch.Tensor, shape: Tuple[int, ...], dev) -> None:
    if t.device != dev or t.dtype != torch.int32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int32 {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_permute(src: torch.Tensor, index: torch.Tensor, k: int,
                backward: bool = False) -> torch.Tensor:
    """Forward: x (T, d) and ``pair`` (R,) -> (R, d).  Backward: dxp
    (R, d) and ``slot`` (T, k) -> dx (T, d)."""
    _rows("moe_permute", src)
    d = src.shape[1]
    lib = build.load()
    if not backward:
        r = index.shape[0] if index.ndim == 1 else -1
        _index("moe_permute pair", index, (r,), src.device)
        out = torch.empty(r, d, dtype=src.dtype, device=src.device)
        rc = lib.repro_moe_permute(src.data_ptr(), index.data_ptr(),
                                   out.data_ptr(), r, k, d,
                                   src.element_size(), _stream(src))
    else:
        t = index.shape[0]
        _index("moe_permute slot", index, (t, k), src.device)
        out = torch.empty(t, d, dtype=src.dtype, device=src.device)
        rc = lib.repro_moe_permute_bwd(src.data_ptr(), index.data_ptr(),
                                       out.data_ptr(), t, k, d,
                                       src.element_size(), _stream(src))
    build.check(rc, "moe_permute")
    build.bump("moe_permute")
    return out


def moe_combine(ye: torch.Tensor, g: torch.Tensor, index: torch.Tensor,
                k: int, dy: Optional[torch.Tensor] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Forward: ye (R, d), gates g (T, k) f32 and ``slot`` (T, k) -> y
    (T, d).  With ``dy`` (T, d): ``index`` is ``pair`` (R,) -> (dye, dg)."""
    _rows("moe_combine", ye)
    r, d = ye.shape
    t = g.shape[0]
    if g.device != ye.device or g.dtype != torch.float32 or \
            tuple(g.shape) != (t, k) or not g.is_contiguous():
        raise ValueError(f"moe_combine: gates must be contiguous float32 "
                         f"({t}, {k}) on {ye.device}")
    lib = build.load()
    if dy is None:
        _index("moe_combine slot", index, (t, k), ye.device)
        y = torch.empty(t, d, dtype=ye.dtype, device=ye.device)
        rc = lib.repro_moe_combine(ye.data_ptr(), g.data_ptr(),
                                   index.data_ptr(), y.data_ptr(), t, k, d,
                                   ye.element_size(), _stream(ye))
        out = y
    else:
        _rows("moe_combine dy", dy, t)
        if dy.dtype != ye.dtype or dy.shape[1] != d:
            raise ValueError("moe_combine: dy must match ye's dtype and "
                             "width")
        _index("moe_combine pair", index, (r,), ye.device)
        dye = torch.empty_like(ye)
        dg = torch.zeros(t, k, dtype=torch.float32, device=ye.device)
        rc = lib.repro_moe_combine_bwd(dy.data_ptr(), ye.data_ptr(),
                                       g.data_ptr(), index.data_ptr(),
                                       dye.data_ptr(), dg.data_ptr(), r, k,
                                       d, ye.element_size(), _stream(ye))
        out = (dye, dg)
    build.check(rc, "moe_combine")
    build.bump("moe_combine")
    return out
