"""Plain PyTorch version of the 1-bit EF-compression kernels.

It is the function the CUDA kernels (``kernel.py``) compute, written as
ordinary tensor operations: the CPU path of ``ops.py`` and the oracle the
kernels are held to on the card.

Wire format (shared with ``repro_torch.core.compression``):
  * ``packed``: uint8 bitmap, bit j of byte i is ``x[8i+j] >= 0`` (LSB
    first);
  * ``scales``: one float32 per ``block_size`` elements, ``mean(|x|)`` over
    the block (the l2-optimal scalar for sign quantization).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_SHIFTS = tuple(range(8))


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(d,) float -> (d/8,) uint8; bit j of byte i = x[8i+j] >= 0."""
    bits = (x >= 0).to(torch.uint8).reshape(-1, 8)
    weights = torch.tensor([1 << j for j in _SHIFTS], dtype=torch.uint8,
                           device=x.device)
    return (bits * weights).sum(dim=1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """(d/8,) uint8 -> (d,) float32 in {-1, +1}."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)


def compress(x: torch.Tensor, block_size: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d,) f32 -> ((d/8,) u8, (d/block,) f32)."""
    if x.ndim != 1 or x.shape[0] % block_size:
        raise ValueError(f"compress: shape {tuple(x.shape)} is not a flat "
                         f"multiple of block_size={block_size}")
    scales = x.reshape(-1, block_size).abs().mean(dim=1)
    return pack_signs(x), scales


def decompress(packed: torch.Tensor, scales: torch.Tensor,
               block_size: int, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """((d/8,) u8, (d/block,) f32) -> (d,) f32, written into ``out``
    when given."""
    signs = unpack_signs(packed).reshape(-1, block_size)
    vals = (signs * scales[:, None]).reshape(-1)
    return vals if out is None else out.copy_(vals)


def ef_compress_fused(x: torch.Tensor, err: torch.Tensor, block_size: int,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """buf = x + err; compress(buf); new_err = buf - decompress (into
    ``out`` when given).

    Returns (packed, scales, new_err)."""
    buf = x + err
    packed, scales = compress(buf, block_size)
    new_err = torch.sub(buf, decompress(packed, scales, block_size),
                        out=out)
    return packed, scales, new_err
