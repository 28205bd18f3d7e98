"""Public 1-bit compression ops: the device of the input decides.

A CUDA tensor takes the Hopper kernel (``kernel.py``), which raises on
anything it does not take; a CPU tensor takes the plain version
(``ref.py``); a meta tensor (the dry run, ``launch.dryrun``) gets empty
outputs of the kernel's shapes and dtypes and counts a launch, computing
nothing.  Any other device raises.  The wire format is the one of
``repro_torch.core.compression``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.onebit import kernel as K
from repro_torch.kernels.onebit import ref as R
from repro_torch.perf import kernel_cost

DEFAULT_BLOCK = K.DEFAULT_BLOCK


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no 1-bit compression path for device {t.device}")


def ef_compress_fused(x: torch.Tensor, err: torch.Tensor,
                      block_size: int = DEFAULT_BLOCK,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused (compress(x+err), new_err) — the EF hot path; ``out``, when
    given, receives new_err."""
    if x.is_meta:
        d = x.shape[0]
        K._check_block(d, block_size)
        build.meta_launch("ef_compress", kernel_cost.ef_compress_cost(
            d, block_size))
        return (x.new_empty(d // 8, dtype=torch.uint8),
                x.new_empty(d // block_size),
                x.new_empty(d) if out is None else out)
    if _on_card(x):
        return K.ef_compress_fused(x, err, block_size, out=out)
    return R.ef_compress_fused(x, err, block_size, out=out)


def compress(x: torch.Tensor, block_size: int = DEFAULT_BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d,) f32 -> (packed (d/8,) u8, scales (d/block,) f32): the fused
    kernel with a zero error, as the reference's ``ops.compress``."""
    packed, scales, _ = ef_compress_fused(x, torch.zeros_like(x), block_size)
    return packed, scales


def decompress(packed: torch.Tensor, scales: torch.Tensor,
               block_size: int = DEFAULT_BLOCK,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    if packed.is_meta:
        d = packed.shape[0] * 8
        K._check_block(d, block_size)
        build.meta_launch("decompress", kernel_cost.decompress_cost(
            d, block_size))
        return scales.new_empty(d) if out is None else out
    if _on_card(packed):
        return K.decompress(packed, scales, block_size, out=out)
    return R.decompress(packed, scales, block_size, out=out)
