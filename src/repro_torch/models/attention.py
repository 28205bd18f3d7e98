"""Self-attention at tp=1, as ``repro/models/attention.py``: projections,
rotary embeddings, GQA head repetition, causal / sliding-window masks, the
prefill paths and KV-cached decode.

Prefill (``attn_forward``) takes one of the reference's paths by
``cfg.attn_impl``:
  * ``"pallas"``: the flash-attention kernel (``kernels/flash_attn``) on
    (B, H, S, D) after the kv heads are repeated, forward only;
  * ``"full"``: the plain masked softmax ``_sdpa``;
  * ``"auto"``: ``"full"``, except where the reference takes its chunked
    online softmax (causal, S > 4 * attn_chunk), which is not ported and
    raises;
  * ``"chunked"``: not ported, raises.

Decode (``decode_attn``) writes the new token's k/v into the cache in
place (the reference returns an updated copy; the port saves the copy)
and attends over the cache in f32.  The flash-decoding sequence sharding
of the reference (``seq_axes``) is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn import ops as fa
from repro_torch.models.common import apply_rope, dense, rope_tables

NEG_INF = -1e30


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


def _qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Project + rope. x: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    hd = cfg.head_dim
    lead = x.shape[:-1]
    q = dense(x, p["wq"]).reshape(*lead, cfg.n_heads, hd)
    k = dense(x, p["wk"]).reshape(*lead, cfg.n_kv_heads, hd)
    v = dense(x, p["wv"]).reshape(*lead, cfg.n_kv_heads, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_forward(p, x: torch.Tensor, cfg: ArchConfig,
                 return_kv: bool = False):
    """Training/prefill self-attention. x: (B, S, d) -> (B, S, d).

    ``return_kv=True`` also returns the pre-repeat (k, v), each
    (B, S, Hkv, hd), so a prefill can seed the decode cache."""
    b, s, _ = x.shape
    hq = cfg.n_heads
    positions = torch.arange(s, device=x.device)[None, :]
    q, k0, v0 = _qkv(p, x, cfg, positions)
    n_rep = hq // cfg.n_kv_heads
    k, v = _repeat_kv(k0, n_rep), _repeat_kv(v0, n_rep)
    use_chunked = (cfg.attn_impl == "chunked" or
                   (cfg.attn_impl == "auto" and s > 4 * cfg.attn_chunk))
    if cfg.attn_impl == "pallas":
        o = fa.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=cfg.causal,
            window=cfg.window).transpose(1, 2)
    elif use_chunked and s % cfg.attn_chunk == 0 and cfg.causal:
        raise NotImplementedError(
            "the chunked online-softmax prefill (reference "
            "models/attention.py:_sdpa_chunked) is not ported (ROADMAP "
            "Queue 1); use attn_impl='full' or 'pallas'")
    else:
        mask = None
        if cfg.causal or cfg.window is not None:
            mask = _causal_mask(s, s, 0, cfg.window, cfg.causal, x.device)
        o = _sdpa(q, k, v, mask)
    out = dense(o.reshape(b, s, hq * cfg.head_dim), p["wo"])
    if return_kv:
        return out, (k0, v0)
    return out


# --- decode with KV cache -----------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device="cpu"
                  ) -> Dict[str, torch.Tensor]:
    """Zero KV cache of one attention layer, (B, S_c, Hkv, hd) each.
    Sliding-window archs cache only the window (a ring buffer)."""
    s = min(seq_len, cfg.window) if cfg.window else seq_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: int, cfg: ArchConfig) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); cache k/v: (B, S_c, Hkv, hd).

    ``pos`` is the absolute position of the new token (== the number of
    valid cache entries).  Writes the token's k/v into ``cache`` in place
    and returns the layer output (B, 1, d)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k_new, v_new = _qkv(p, x, cfg, torch.full((1, 1), pos,
                                                 device=x.device))
    s_c = cache["k"].shape[1]
    if cfg.window:
        slot = pos % s_c                  # ring buffer over the window
    elif pos < s_c:
        slot = pos
    else:
        raise ValueError(f"decode position {pos} is past the cache's "
                         f"{s_c} slots")
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    # q head g * n_rep + r reads kv head g, as _repeat_kv lays them out
    kc = cache["k"].to(torch.float32)
    vc = cache["v"].to(torch.float32)
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qf, kc) / (hd ** 0.5)
    gpos = torch.arange(s_c, device=x.device)
    if cfg.window and pos >= s_c - 1:
        valid = torch.ones(s_c, dtype=torch.bool, device=x.device)
    else:
        valid = gpos <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", w, vc)
    o = o.to(x.dtype).reshape(b, 1, hq * hd)
    return dense(o, p["wo"])
