"""Wrappers around the Hopper 1-bit kernels in ``csrc/onebit.cu``.

They replace the TPU kernels of ``src/repro/kernels/onebit/kernel.py``
(``ef_compress_fused`` and ``decompress``).  Each wrapper checks device,
dtype, contiguity and shapes, allocates its outputs with ``torch.empty``
(or writes its f32 output into the caller's ``out``, which may be a
slice of a larger tensor),
launches on ``torch.cuda.current_stream()`` without synchronising, counts
the launch, and raises if the entry point reports a CUDA error.  CUDA
tensors only: the plain version lives in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DEFAULT_BLOCK = 4096


def _check_f32(name: str, t: torch.Tensor, n: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.ndim != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected float32 ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_block(d: int, block_size: int) -> None:
    """The reference's contract: a positive multiple of 8 (whole packed
    bytes per block) that divides ``d``."""
    if block_size <= 0 or block_size % 8:
        raise ValueError(f"block_size={block_size} must be a positive "
                         "multiple of 8")
    if d % block_size:
        raise ValueError(f"length {d} is not a multiple of "
                         f"block_size={block_size}")


def _out(out, like: torch.Tensor, n: int, align: int = 4) -> torch.Tensor:
    """``out`` checked as a (n,) f32 destination on ``like``'s card whose
    address is a multiple of ``align`` bytes, or a new one."""
    if out is None:
        return torch.empty(n, dtype=torch.float32, device=like.device)
    _check_f32("out", out, n)
    if out.device != like.device:
        raise ValueError(f"out on {out.device}, inputs on {like.device}")
    if out.data_ptr() % align:
        raise ValueError(f"out must be {align}-byte aligned")
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ef_compress_fused(x: torch.Tensor, err: torch.Tensor,
                      block_size: int = DEFAULT_BLOCK,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EF-compress of (d,) f32 ``x`` and ``err`` on the card.

    Returns (packed (d/8,) u8, scales (d/block,) f32, new_err (d,) f32);
    new_err is ``out`` when given (it must not overlap ``x`` or ``err``)."""
    d = x.shape[0] if x.ndim == 1 else -1
    _check_block(d, block_size)
    _check_f32("x", x, d)
    _check_f32("err", err, d)
    if err.device != x.device:
        raise ValueError(f"err on {err.device}, x on {x.device}")
    lib = build.load()
    packed = torch.empty(d // 8, dtype=torch.uint8, device=x.device)
    scales = torch.empty(d // block_size, dtype=torch.float32,
                         device=x.device)
    new_err = _out(out, x, d)
    rc = lib.repro_ef_compress(x.data_ptr(), err.data_ptr(),
                               packed.data_ptr(), scales.data_ptr(),
                               new_err.data_ptr(), d, block_size, _stream(x))
    build.check(rc, "ef_compress")
    build.bump("ef_compress")
    return packed, scales, new_err


def decompress(packed: torch.Tensor, scales: torch.Tensor,
               block_size: int = DEFAULT_BLOCK,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(d/8,) u8 + (d/block,) f32 on the card -> (d,) f32, written into
    ``out`` when given."""
    if not (packed.is_cuda and scales.is_cuda):
        raise ValueError("decompress: expected CUDA tensors, got "
                         f"{packed.device} and {scales.device}")
    if packed.device != scales.device:
        raise ValueError(f"packed on {packed.device}, scales on "
                         f"{scales.device}")
    if packed.dtype != torch.uint8 or packed.ndim != 1 \
            or not packed.is_contiguous():
        raise ValueError("packed: expected contiguous uint8 (d/8,), got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    d = packed.shape[0] * 8
    _check_block(d, block_size)
    _check_f32("scales", scales, d // block_size)
    lib = build.load()
    out = _out(out, packed, d, align=16)      # the kernel's float4 stores
    rc = lib.repro_decompress(packed.data_ptr(), scales.data_ptr(),
                              out.data_ptr(), d, block_size, _stream(packed))
    build.check(rc, "decompress")
    build.bump("decompress")
    return out
