"""Public flash-attention op: the reference's contract, the device decides.

As ``repro/kernels/flash_attn/ops.py``: block sizes ``bq``/``bk`` default
to 256 and are clamped to S, and S must be a multiple of both (the
reference asserts; here ``ValueError``).  A CUDA tensor takes a Hopper
kernel (``kernel.py``: bf16 and fp16 the wgmma kernel, f32 and head dims
above 256 the split kernel, whose three-term bf16 products keep f32
accuracy; their own tiles only change the order of the f32 sums), which
raises on what it does not take; a CPU tensor takes the plain version
(``ref.py``); a meta tensor (the dry run) gets an empty output and
counts a launch of the kernel its dtype and head dim route to, computing
nothing.  Any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import kernel as K
from repro_torch.kernels.flash_attn import ref as R
from repro_torch.perf import kernel_cost

DEFAULT_BQ = 256
DEFAULT_BK = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    bq: Optional[int] = None, bk: Optional[int] = None
                    ) -> torch.Tensor:
    """(B, H, S, D) attention with an online softmax; (B, H, S, D) out."""
    s = q.shape[2]
    bq = min(bq or DEFAULT_BQ, s)
    bk = min(bk or DEFAULT_BK, s)
    if s % bq or s % bk:
        raise ValueError(f"flash_attention: S={s} must be a multiple of "
                         f"bq={bq} and bk={bk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is forward only (prefill), as "
                         "the reference's kernel; train with "
                         "attn_impl='full'")
    if q.is_meta:
        build.meta_launch(K.route(q), kernel_cost.flash_attention_cost(
            *q.shape, q.element_size(), causal, window))
        return torch.empty_like(q)
    if q.is_cuda:
        return K.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return R.sdpa(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash-attention path for device {q.device}")
