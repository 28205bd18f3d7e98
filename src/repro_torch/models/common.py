"""Shared layers (tensor parallelism of the reference is tp=1 here, so its
collective helpers are identities and are not ported)."""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

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


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dim: the output has
    ceil(size / stride) positions and the odd pixel goes to the high side,
    so a 3 x 3 stride-2 conv pads (0, 1) on an even size, where
    ``F.conv2d(padding=1)`` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """NCHW conv with an HWIO weight (the reference's leaf layout) and
    SAME padding: ``lax.conv_general_dilated(..., padding="SAME",
    dimension_numbers=("NHWC", "HWIO", "NHWC"))`` in NCHW."""
    kh, kw = w.shape[:2]
    ph = same_padding(x.shape[2], kh, stride)
    pw = same_padding(x.shape[3], kw, stride)
    x = torch.nn.functional.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1),
                                      stride=stride)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The reference's NHWC group norm on NCHW: ``min(groups, C)``
    contiguous channel groups, population variance, ``eps`` inside the
    rsqrt, then a per-channel scale and bias."""
    return torch.nn.functional.group_norm(x, min(groups, x.shape[1]),
                                          scale, bias, eps)


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """TF32 off for cuBLAS matmuls and cuDNN convs (torch's cuDNN default
    would run the f32 convs in TF32) while the block runs; the flags as
    they were on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
