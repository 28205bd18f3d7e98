"""Plain PyTorch version of the LM-head cross-entropy kernels.

The formula of ``models/transformer.py`` ``vocab_parallel_xent`` on this
rank's shard, split where the kernels split it: the forward gives per row
the max ``m_l`` of the f32 logits (the padded vocab masked to -1e30), the
sum ``s_l`` of ``exp(logit - m_l)`` and the label's logit ``ll_l`` (0 when
the label lies on another rank's shard); the backward takes the
cotangents ``a`` of ``s_l`` and ``b`` of ``ll_l`` and gives dX and dW
through the logits' gradient ``a exp(logit - m_l) + b onehot(label)``.
The logits are ``x.to(f32) @ w.to(f32)`` as before, so on the CPU the
loss and its gradients keep the plain formula's numbers.  ``plain_nll``
is that formula whole, as the model computed it before these kernels:
the logits held in memory and reduced by autograd, the yardstick of the
kernels' tests and bench.  ``split3`` is the kernels' three-piece bf16
split of an f32 tensor.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

MASK = -1e30


def split3(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Three bf16 pieces of an f32 tensor whose f32 sum is ``v``: ``hi``
    and ``mid`` keep the top 8 significant bits of what is left (by
    truncation, so ``hi`` never rounds up past the f32 range) and ``lo``
    the rest, rounded.  Bitwise wherever ``lo`` stays above bf16's
    smallest subnormal (2^-133): every normal ``v`` with |v| >= 2^-110."""
    v = v.to(torch.float32)
    hi = (v.view(torch.int32) & -65536).view(torch.float32)
    r = v - hi
    mid = (r.view(torch.int32) & -65536).view(torch.float32)
    lo = r - mid
    return (hi.to(torch.bfloat16), mid.to(torch.bfloat16),
            lo.to(torch.bfloat16))


def _logits(x: torch.Tensor, w: torch.Tensor, n_keep: int) -> torch.Tensor:
    """x @ w in f32 (f64 for an f64 w), the columns from ``n_keep`` on
    masked."""
    dt = torch.promote_types(w.dtype, torch.float32)
    logits = x.to(dt) @ w.to(dt)
    keep = torch.arange(logits.shape[-1], device=logits.device) < n_keep
    return torch.where(keep, logits, MASK)


def forward(x: torch.Tensor, w: torch.Tensor, lab: torch.Tensor,
            n_keep: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m_l, s_l, ll_l) of x (T, d) and w (d, V_l); ``lab`` (T,) holds the
    label's local column, or -1 where it lies on another shard."""
    logits = _logits(x, w, n_keep)
    m = logits.max(dim=-1).values
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    ll = logits.gather(-1, lab.long().clamp(min=0)[..., None])[..., 0]
    return m, s, torch.where(lab >= 0, ll, 0.0)


def backward(x: torch.Tensor, w: torch.Tensor, lab: torch.Tensor,
             n_keep: int, m: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX, dW), both f32, for the cotangents ``a`` of s_l and ``b`` of
    ll_l, the logits recomputed."""
    logits = _logits(x, w, n_keep)
    ds = a[..., None] * torch.exp(logits - m[..., None])
    hit = torch.zeros_like(ds).scatter_(
        -1, lab.long().clamp(min=0)[..., None],
        torch.where(lab >= 0, b, 0.0)[..., None])
    keep = torch.arange(ds.shape[-1], device=ds.device) < n_keep
    ds = torch.where(keep, ds + hit, 0.0)
    return ds @ w.to(torch.float32).t(), x.to(torch.float32).t() @ ds


def plain_nll(x: torch.Tensor, w: torch.Tensor, lab: torch.Tensor,
              n_keep: int,
              row_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              row_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(per-row loss, label logit, row max) through the whole logits, held
    in memory and differentiated by autograd, the row max detached: the
    path the kernels replace.  ``lab`` holds this shard's label column or
    -1; ``row_max`` and ``row_sum`` combine a row's max and its sums over
    the shards of a model axis (nothing on one)."""
    logits = _logits(x, w, n_keep)
    m = logits.max(dim=-1).values.detach()
    if row_max is not None:
        m = row_max(m)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    ll = logits.gather(-1, lab.long().clamp(min=0)[..., None])[..., 0]
    ll = torch.where(lab >= 0, ll, 0.0)
    if row_sum is not None:
        se, ll = row_sum(se), row_sum(ll)
    return torch.log(se) + m - ll, ll, m
