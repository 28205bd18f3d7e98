"""Shared layers (tensor parallelism of the reference is tp=1 here, so its
collective helpers are identities and are not ported)."""
from __future__ import annotations

from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Variance in f32; the product is taken before the cast back."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings at ``positions`` (..., S):
    returns cos, sin of shape (..., S, head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: bf16 operands accumulate in f32 (cuBLAS), then
    the result is rounded to x's dtype, as the reference's
    ``preferred_element_type=f32`` einsum followed by the cast."""
    return torch.matmul(x, w.to(x.dtype))
