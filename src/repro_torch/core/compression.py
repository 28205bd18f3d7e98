"""Error-compensated 1-bit compression (the paper's C_omega operator).

The wire format is real: signs are packed 8 per uint8 (bit j of byte i is
``x[8i+j] >= 0``, LSB first) and one float32 scale, ``mean(|x|)``, is kept
per block, so a compressed tensor of ``d`` float32 elements costs
``d/8 + 4*d/block_size`` bytes on the wire instead of ``4*d``.

Error feedback invariant (exact in floating point, by construction):

    compressed_value + error == input        (elementwise)

because ``error = input - decompress(compress(input))``.

Every function routes through :mod:`repro_torch.kernels.onebit.ops`, so a
CUDA tensor takes the Hopper kernel and a CPU tensor the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels.onebit import ops as _ops
from repro_torch.kernels.onebit.ref import pack_signs, unpack_signs

__all__ = ["DEFAULT_BLOCK", "CompressionConfig", "padded_length",
           "pack_signs", "unpack_signs", "compress_onebit",
           "decompress_onebit", "ef_compress", "ef_decompress",
           "wire_bytes", "compression_error_norm"]

DEFAULT_BLOCK = _ops.DEFAULT_BLOCK  # elements per scale block


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """``kind``: "onebit" (sign + per-block mean-|x| scale) or "identity"
    (no-op, the paper's "1-bit Adam (32-bits)" ablation)."""

    kind: str = "onebit"
    block_size: int = DEFAULT_BLOCK

    def __post_init__(self):
        if self.kind not in ("onebit", "identity"):
            raise ValueError(f"unknown compression kind {self.kind!r}")
        if self.block_size <= 0 or self.block_size % 8:
            raise ValueError("block_size must pack into bytes")


def padded_length(d: int, n_chunks: int, block_size: int = DEFAULT_BLOCK
                  ) -> int:
    """Smallest length >= d divisible by n_chunks * block_size."""
    q = n_chunks * block_size
    return ((d + q - 1) // q) * q


def compress_onebit(x: torch.Tensor, block_size: int = DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d,) f32 -> (packed (d/8,) u8, scales (d/block,) f32)."""
    return _ops.compress(x, block_size)


def decompress_onebit(packed: torch.Tensor, scales: torch.Tensor,
                      block_size: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Inverse of compress_onebit: (d/8,) u8 + (d/block,) f32 -> (d,) f32."""
    return _ops.decompress(packed, scales, block_size)


def ef_compress(x: torch.Tensor, err: torch.Tensor, cfg: CompressionConfig
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Error-feedback compress: compress(x + err) and the new error.

    Returns ((packed, scales), new_err) for kind="onebit"; for
    kind="identity" the "packed" entry is the raw buffer, scales is a
    size-0 placeholder and new_err is zero."""
    if cfg.kind == "identity":
        buf = x + err
        return ((buf, torch.zeros(0, dtype=torch.float32, device=x.device)),
                torch.zeros_like(buf))
    packed, scales, new_err = _ops.ef_compress_fused(x, err, cfg.block_size)
    return (packed, scales), new_err


def ef_decompress(payload: Tuple[torch.Tensor, torch.Tensor],
                  cfg: CompressionConfig) -> torch.Tensor:
    """The value a payload of :func:`ef_compress` stands for: the raw
    buffer under kind="identity", else the decompressed signs."""
    packed, scales = payload
    if cfg.kind == "identity":
        return packed
    return decompress_onebit(packed, scales, cfg.block_size)


def wire_bytes(d: int, cfg: CompressionConfig) -> int:
    """Bytes on the wire for a d-element float32 payload under cfg."""
    if cfg.kind == "identity":
        return 4 * d
    return d // 8 + 4 * (d // cfg.block_size)


def compression_error_norm(x: torch.Tensor, block_size: int = DEFAULT_BLOCK
                           ) -> torch.Tensor:
    """||x - decompress(compress(x))||: the diagnostic of Assumption 1's
    eps."""
    packed, scales = compress_onebit(x, block_size)
    return torch.linalg.vector_norm(
        x - decompress_onebit(packed, scales, block_size))
