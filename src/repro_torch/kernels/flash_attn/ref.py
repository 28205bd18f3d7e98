"""Plain PyTorch version of the flash-attention forward kernel.

It is the function the CUDA kernel (``kernel.py``) computes, written as
ordinary tensor operations, as ``repro/kernels/flash_attn/ref.py:sdpa``:
scores in f32, masked entries set to -1e30 (causal, and a sliding window
when given), an f32 softmax, and the output rounded once to the input
dtype.  It is the CPU path of ``ops.py`` and the oracle the kernel is
held to on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool = True, window: Optional[int] = None,
         head_dim: Optional[int] = None) -> torch.Tensor:
    """q/k/v: (B, H, S, D) -> (B, H, S, D) in q's dtype.  The scores are
    divided by sqrt(head_dim), D by default (a zero-padded input passes
    its true D)."""
    d = head_dim or q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    sq, sk = q.shape[2], k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    keep = (kj <= qi) if causal else torch.ones(sq, sk, dtype=torch.bool,
                                                device=q.device)
    if window is not None:
        keep = keep & (kj > qi - window)
    s = torch.where(keep, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w,
                        v.to(torch.float32)).to(q.dtype)
