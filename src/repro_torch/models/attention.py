"""Self-attention, as ``repro/models/attention.py``: projections, rotary
embeddings, GQA head repetition, causal / sliding-window masks, the
prefill paths and KV-cached decode.

Tensor parallelism (training and serving), this rank's shard of the
reference's global layout at tp (``shard_dims``):
  wq (d, Hq_l * hd)    column-parallel, Hq_l = padded_heads(tp) / tp
  wk, wv (d, Hkv_l * hd)  column-parallel over the kv heads when
                       n_kv >= tp; otherwise each rank holds one kv head,
                       duplicated over groups of tp / n_kv ranks (the
                       global columns repeat each head), its gradient
                       summed within the group (``grouped_param``)
  wo (Hq_l * hd, d)    row-parallel, closed by ``f_reduce``
Rank r holds q heads [r * Hq_l, (r + 1) * Hq_l) and exactly the kv heads
they read.

Prefill (``attn_forward``) takes one of the reference's paths by
``cfg.attn_impl``:
  * ``"pallas"``: the flash-attention kernel (``kernels/flash_attn``) on
    (B, H, S, D) after the kv heads are repeated, forward only;
  * ``"full"``: the plain masked softmax ``_sdpa``;
  * ``"chunked"``: the online softmax over KV chunks of ``attn_chunk``
    (``_sdpa_chunked``, the flash schedule in plain torch, f32) for a
    causal model whose length the chunk divides, else ``"full"``;
  * ``"auto"``: ``"chunked"`` past S = 4 * attn_chunk, else ``"full"``.

Decode (``decode_attn``) writes the new token's k/v into the cache in
place (the reference returns an updated copy; the port saves the copy)
and attends over the cache in f32.  Under tensor parallelism the cache
holds this rank's kv heads (a duplicated kv head: its own copy) and the
output closes with ``f_reduce``.  A cache may be split along the
sequence over a group of ranks (``SeqGroup``, the reference's
``seq_axes``; flash-decoding): only the shard that holds the new slot
writes it, each rank attends over its own slots, and the partial softmax
sums are combined by an all-reduce MAX of the row maxima and one SUM of
the rescaled sums and outputs.  A windowed (ring) cache is never split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn import ops as fa
from repro_torch.models.common import (NO_TP, ParallelCtx, apply_rope,
                                       dense, f_reduce, g_copy,
                                       grouped_param, rope_tables)

NEG_INF = -1e30


def shard_dims(cfg: ArchConfig, tp: int = 1) -> Tuple[int, int, int]:
    """(q heads a rank, kv heads a rank, kv-duplicate group size)."""
    hq = cfg.padded_heads(tp) // tp
    if cfg.n_kv_heads >= tp:
        if cfg.n_kv_heads % tp:
            raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over "
                             f"{tp} model ranks")
        return hq, cfg.n_kv_heads // tp, 1
    if tp % cfg.n_kv_heads:
        raise ValueError(f"{tp} model ranks do not split into groups of "
                         f"the {cfg.n_kv_heads} kv heads")
    return hq, 1, tp // cfg.n_kv_heads


def attn_shapes(cfg: ArchConfig, tp: int = 1) -> Dict[str, Tuple[int, ...]]:
    """Global shapes of one attention layer's leaves at ``tp``: the q heads
    padded to a multiple of tp, the kv head columns repeated when
    n_kv < tp (head order 0, 0, 1, 1, ...), so that a contiguous shard
    gives each rank its own copy."""
    hd, d = cfg.head_dim, cfg.d_model
    hq, hkv, _ = shard_dims(cfg, tp)
    return {"wq": (d, tp * hq * hd), "wk": (d, tp * hkv * hd),
            "wv": (d, tp * hkv * hd), "wo": (tp * hq * hd, d)}


# the dim of each leaf split over the model axis
ATTN_SPECS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd) by head repetition."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _causal_mask(sq: int, skv: int, q_offset: int, window: Optional[int],
                 causal: bool = True, device=None) -> torch.Tensor:
    """(sq, skv) bool mask; q position i may see kv position j."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    m = (kj <= qi) if causal else torch.ones(sq, skv, dtype=torch.bool,
                                             device=device)
    if window is not None:
        m = m & (kj > qi - window)
    return m


def _sdpa(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,H,hd), mask (Sq,Skv) or None (nothing
    masked). Scores and softmax in f32, weights cast to q's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)


def _sdpa_chunked(q, k, v, q_offset: int, window: Optional[int],
                  chunk: int) -> torch.Tensor:
    """Causal online softmax over KV chunks (the flash-attention schedule
    in plain torch, f32): O(Sq * chunk) scores at a time instead of
    O(Sq * Skv).  q: (B,Sq,H,hd), k/v: (B,Skv,H,hd), Skv a multiple of
    ``chunk``."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if skv % chunk:
        raise ValueError(f"{skv} keys do not split into chunks of {chunk}")
    dev = q.device
    qf = q.to(torch.float32)
    qi = torch.arange(sq, device=dev)[:, None] + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    for i in range(skv // chunk):
        kb = k[:, i * chunk:(i + 1) * chunk].to(torch.float32)
        vb = v[:, i * chunk:(i + 1) * chunk].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) / (hd ** 0.5)
        kj = torch.arange(chunk, device=dev)[None, :] + i * chunk
        msk = kj <= qi
        if window is not None:
            msk = msk & (kj > qi - window)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (b,sq,h,hd)


def _qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         ctx: ParallelCtx = NO_TP, skip_gcopy: bool = False):
    """Project + rope. x: (B, S, d) -> q (B,S,Hq_l,hd), k/v (B,S,Hkv_l,hd).
    ``skip_gcopy``: x came through ``sp_gather``, whose backward already
    sums the ranks' partial cotangents."""
    hd = cfg.head_dim
    hq, hkv, rep = shard_dims(cfg, ctx.tp)
    lead = x.shape[:-1]
    xin = x if skip_gcopy else g_copy(x, ctx)
    q = dense(xin, p["wq"]).reshape(*lead, hq, hd)
    k = dense(xin, grouped_param(p["wk"], ctx, rep)).reshape(*lead, hkv, hd)
    v = dense(xin, grouped_param(p["wv"], ctx, rep)).reshape(*lead, hkv, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_forward(p, x: torch.Tensor, cfg: ArchConfig,
                 return_kv: bool = False, ctx: ParallelCtx = NO_TP,
                 outer: str = "tp"):
    """Training/prefill self-attention. x: (B, S, d) -> (B, S, d).

    ``return_kv=True`` also returns the pre-repeat (k, v), each
    (B, S, Hkv_l, hd), so a prefill can seed the decode cache.
    ``outer="none"`` (sequence parallelism): the caller owns the boundary
    collectives; x is already gathered and the output is this rank's
    partial row-parallel sum (no ``f_reduce``)."""
    b, s, _ = x.shape
    hq, hkv, _ = shard_dims(cfg, ctx.tp)
    positions = torch.arange(s, device=x.device)[None, :]
    q, k0, v0 = _qkv(p, x, cfg, positions, ctx, skip_gcopy=outer == "none")
    n_rep = hq // hkv
    k, v = _repeat_kv(k0, n_rep), _repeat_kv(v0, n_rep)
    use_chunked = (cfg.attn_impl == "chunked" or
                   (cfg.attn_impl == "auto" and s > 4 * cfg.attn_chunk))
    if cfg.attn_impl == "pallas":
        o = fa.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=cfg.causal,
            window=cfg.window).transpose(1, 2)
    elif use_chunked and s % cfg.attn_chunk == 0 and cfg.causal:
        o = _sdpa_chunked(q, k, v, 0, cfg.window, cfg.attn_chunk)
    else:
        mask = None
        if cfg.causal or cfg.window is not None:
            mask = _causal_mask(s, s, 0, cfg.window, cfg.causal, x.device)
        o = _sdpa(q, k, v, mask)
    out = dense(o.reshape(b, s, hq * cfg.head_dim), p["wo"])
    if outer != "none":
        out = f_reduce(out, ctx)
    if return_kv:
        return out, (k0, v0)
    return out


# --- decode with KV cache -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """The ranks a KV cache's sequence is split over: their process group
    (None: the default group), this rank's shard index and the count."""

    group: Optional[object]
    index: int
    size: int


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device="cpu", seq_shards: int = 1,
                  tp: int = 1) -> Dict[str, torch.Tensor]:
    """Zero KV cache of one attention layer, (B, S_c, tp * Hkv_l, hd) each
    (global shapes at ``tp``: a kv head duplicated over the model ranks is
    cached once a rank).  Sliding-window archs cache only the window (a
    ring buffer); with ``seq_shards`` > 1 the sequence is rounded up to a
    multiple of it, to be split over that many ranks."""
    if cfg.window:
        s = min(seq_len, cfg.window)
    else:
        s = -(-seq_len // seq_shards) * seq_shards
    shape = (batch, s, tp * shard_dims(cfg, tp)[1], cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: int, cfg: ArchConfig,
                seq_group: Optional[SeqGroup] = None,
                ctx: ParallelCtx = NO_TP) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); cache k/v: (B, S_c, Hkv_l, hd), this
    rank's kv heads under ``ctx`` and its shard of the sequence under
    ``seq_group``.

    ``pos`` is the absolute position of the new token (== the number of
    valid cache entries).  Writes the token's k/v into ``cache`` in place
    (on the shard that owns the slot) and returns the layer output
    (B, 1, d)."""
    if cfg.window and seq_group is not None:
        raise ValueError("a windowed (ring) KV cache is not split over the "
                         "sequence")
    b = x.shape[0]
    hq, hkv, _ = shard_dims(cfg, ctx.tp)
    hd = cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, torch.full((1, 1), pos,
                                                 device=x.device), ctx)
    s_c = cache["k"].shape[1]
    shard, n_shards = (0, 1) if seq_group is None else \
        (seq_group.index, seq_group.size)
    if cfg.window:
        slot = pos % s_c                  # ring buffer over the window
    elif pos < s_c * n_shards:
        slot = pos
    else:
        raise ValueError(f"decode position {pos} is past the cache's "
                         f"{s_c * n_shards} slots")
    if slot // s_c == shard:              # only the owner shard writes
        cache["k"][:, slot % s_c] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot % s_c] = v_new[:, 0].to(cache["v"].dtype)

    # q head g * n_rep + r reads kv head g, as _repeat_kv lays them out
    kc = cache["k"].to(torch.float32)
    vc = cache["v"].to(torch.float32)
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qf, kc) / (hd ** 0.5)
    gpos = torch.arange(s_c, device=x.device) + shard * s_c
    if cfg.window and pos >= s_c - 1:
        valid = torch.ones(s_c, dtype=torch.bool, device=x.device)
    else:
        valid = gpos <= pos
    s = torch.where(valid, s, NEG_INF)
    if seq_group is None:
        o = torch.einsum("bgrk,bkgd->bgrd", torch.softmax(s, dim=-1), vc)
    else:
        # flash-decoding: the global row max, then the rescaled partial
        # sums and outputs summed over the shards
        m = s.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=seq_group.group)
        p_ = torch.exp(s - m[..., None])
        lo = torch.cat([torch.einsum("bgrk,bkgd->bgrd", p_, vc),
                        p_.sum(dim=-1)[..., None]], dim=-1)
        dist.all_reduce(lo, group=seq_group.group)
        o = lo[..., :hd] / torch.clamp(lo[..., hd:], min=1e-30)
    o = o.to(x.dtype).reshape(b, 1, hq * hd)
    return f_reduce(dense(o, p["wo"]), ctx)
