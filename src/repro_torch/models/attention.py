"""Training self-attention at tp=1: projections, rotary embeddings, GQA
head repetition, and the plain scaled-dot-product path of the reference
(``repro/models/attention.py:_sdpa``) written as matmul + softmax.

The reference's chunked online-softmax path only runs for causal models
at long sequence, and its Pallas flash-attention kernel only for serving;
both are later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import apply_rope, dense, rope_tables

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd) by head repetition."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _sdpa(q, k, v, causal: bool) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,H,hd). Scores and softmax in f32."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / (hd ** 0.5)
    if causal:
        sq, skv = scores.shape[-2:]
        keep = torch.ones(sq, skv, dtype=torch.bool,
                          device=scores.device).tril()
        scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)


def attn_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = dense(x, p["wq"]).reshape(b, s, hq, hd)
    k = dense(x, p["wk"]).reshape(b, s, hkv, hd)
    v = dense(x, p["wv"]).reshape(b, s, hkv, hd)
    positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    o = _sdpa(q, k, v, cfg.causal).reshape(b, s, hq * hd)
    return dense(o, p["wo"])
