"""Feed-forward layers: gelu (the BERT encoder), SwiGLU (the decoders),
and the MoE layer with capacity-based dispatch, as ``repro/models/mlp.py``.

The dense MLP is Megatron's pair: wg / wu column-parallel, wd row-parallel,
closed by ``f_reduce``.  The MoE layer's experts are split over the model
axis (``moe_layout``): with E >= tp each rank holds E / tp whole experts
(expert parallelism); with E < tp each expert's d_ff is split over
tp / E ranks (ff slices).  The global leaves stack tp * (experts a rank)
expert blocks; block ``r * e_per + j`` is rank r's j-th, and holds expert
``block // rep``'s slice ``block % rep``.  Every rank sees every token
(the activations are replicated between blocks), so dispatch is a local
gather of the tokens routed to this rank's blocks, and the one
``f_reduce`` that closes the layer also sums the experts' (and slices')
contributions: no all-to-all.  The router runs on the replicated x; its
logits go through ``g_copy``, so backward sums the ranks' partial gate
cotangents into one router gradient, the same on every rank.  Under
sequence parallelism (``outer="none"``) the router runs on this rank's
token shard and its logits are ``sp_gather``ed instead, and the
load-balance loss, from the shard's own tokens, is averaged over the
model axis.

The router runs in f32; its softmax's top-k choices, renormalised
to sum 1, are the gates.  Each (token, choice) takes the next slot of its
expert's capacity buffer, in the order of the flattened (t * k, E)
one-hot (an exclusive cumsum in C order); a choice whose slot lands at or
past ``capacity = max(ceil(t * k / E * capacity_factor), 4)`` is dropped.
Two dispatches compute the same layer:

  * ``"einsum"``: one-hot (t, capacity) matrices gather the tokens into
    the expert's buffer and scatter its outputs back (matmuls);
  * ``"gather"``: the slots' token indices gather the tokens
    (``index_select``) and a scatter-add returns the gated outputs
    (``index_add``; on CUDA its atomics make it non-bitwise from run to
    run).

The auxiliary loss is the Switch load-balance term ``E * sum_e frac_e *
mean p_e`` over the top-1 choices.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (NO_TP, ParallelCtx, dense, f_reduce,
                                       g_copy, pmean, rep_param, sp_gather,
                                       tp_rank)

# the dim of each leaf split over the model axis (None: replicated)
MLP_SPECS = {"wg": 1, "wu": 1, "wd": 0}
MOE_SPECS = {"router": None, "wg": 0, "wu": 0, "wd": 0}


def mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Global shapes of one dense MLP layer's leaves (``wu`` for SwiGLU
    only)."""
    d, ff = cfg.d_model, cfg.d_ff
    out = {"wg": (d, ff), "wd": (ff, d)}
    if cfg.mlp_kind == "swiglu":
        out["wu"] = (d, ff)
    return out


def mlp_param_specs(cfg: ArchConfig) -> Dict[str, Optional[int]]:
    """{leaf: the dim split over the model axis} of one dense MLP."""
    return {k: MLP_SPECS[k] for k in mlp_shapes(cfg)}


def init_mlp(generator: torch.Generator, cfg: ArchConfig, tp: int = 1
             ) -> Dict[str, torch.Tensor]:
    """One dense MLP layer's leaves, drawn as ``init_params`` draws
    them."""
    from repro_torch.models.transformer import init_layer
    return init_layer(cfg, "ffn", mlp_shapes(cfg), generator, tp)


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig,
                ctx: ParallelCtx = NO_TP, outer: str = "tp"
                ) -> torch.Tensor:
    """``outer="none"``: x already gathered, the output this rank's partial
    sum (sequence parallelism)."""
    xin = x if outer == "none" else g_copy(x, ctx)
    if cfg.mlp_kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(xin, p["wg"]), approximate="tanh")
    elif cfg.mlp_kind == "swiglu":
        h = F.silu(dense(xin, p["wg"])) * dense(xin, p["wu"])
    else:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    out = dense(h, p["wd"])
    return out if outer == "none" else f_reduce(out, ctx)


def moe_layout(cfg: ArchConfig, tp: int = 1) -> Tuple[int, int, int]:
    """(experts a rank, ff slices an expert, local d_ff)."""
    e = cfg.n_experts
    if e >= tp:
        if e % tp:
            raise ValueError(f"{e} experts do not split over {tp} model "
                             "ranks")
        return e // tp, 1, cfg.d_ff
    if tp % e or cfg.d_ff % (tp // e):
        raise ValueError(f"{tp} model ranks do not split {e} experts of "
                         f"d_ff {cfg.d_ff} into slices")
    return 1, tp // e, cfg.d_ff // (tp // e)


def moe_shapes(cfg: ArchConfig, tp: int = 1) -> Dict[str, Tuple[int, ...]]:
    """Global shapes of one MoE layer's leaves at ``tp``."""
    e_per, _, ff_l = moe_layout(cfg, tp)
    d, nb = cfg.d_model, tp * e_per
    return {"router": (d, cfg.n_experts), "wg": (nb, d, ff_l),
            "wu": (nb, d, ff_l), "wd": (nb, ff_l, d)}


def moe_param_specs(cfg: ArchConfig) -> Dict[str, Optional[int]]:
    """{leaf: the dim split over the model axis} of one MoE layer (the
    expert blocks; the router replicated)."""
    return dict(MOE_SPECS)


def init_moe(generator: torch.Generator, cfg: ArchConfig, tp: int = 1
             ) -> Dict[str, torch.Tensor]:
    """One MoE layer's global leaves at ``tp`` (expert blocks stacked on a
    leading axis), drawn as ``init_params`` draws them."""
    from repro_torch.models.transformer import init_layer
    return init_layer(cfg, "ffn", moe_shapes(cfg, tp), generator, tp)


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert holds for ``t`` tokens of this microbatch."""
    return max(int(math.ceil(t * cfg.moe_top_k / cfg.n_experts
                             * cfg.capacity_factor)), 4)


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig,
                ctx: ParallelCtx = NO_TP, outer: str = "tp",
                x_shard: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), aux), aux the layer's Switch
    load-balance loss (f32 scalar).  ``outer="none"`` (sequence
    parallelism): x is the gathered sequence, ``x_shard`` this rank's
    (B, S/tp, d) chunk, and the output this rank's partial sum."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    e_per, rep, _ = moe_layout(cfg, ctx.tp)

    router = rep_param(p["router"], ctx).to(torch.float32)
    if outer == "none":
        if x_shard is None:
            raise ValueError("sequence parallelism needs x_shard")
        xin = x.reshape(t, d)
        aux_logits = x_shard.reshape(-1, d).to(torch.float32) @ router
        logits = sp_gather(aux_logits.reshape(b, -1, e), ctx,
                           dim=1).reshape(t, e)
        probs = torch.softmax(logits, dim=-1)
    else:
        # the router on the replicated x, its logits through g_copy (see
        # the module doc)
        xin = g_copy(x, ctx).reshape(t, d)
        aux_logits = x.reshape(t, d).to(torch.float32) @ router
        probs = torch.softmax(g_copy(aux_logits, ctx), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                    # (t, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = moe_capacity(cfg, t)
    # slot of each (token, choice) in its expert's buffer
    flat = F.one_hot(idx, e).reshape(t * k, e)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(dim=-1).reshape(t, k)
    keep = pos < capacity

    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    tok_ids = torch.arange(t, device=x.device)[:, None].expand(t, k)
    r = tp_rank(ctx)
    for j in range(e_per):
        sel = (idx == (r * e_per + j) // rep) & keep            # (t, k)
        slot = torch.where(sel, pos, capacity)                  # dropped
        gsel = torch.where(sel, gate, 0.0)
        wg, wu, wd = p["wg"][j], p["wu"][j], p["wd"][j]
        if cfg.moe_dispatch == "gather":
            # slot `capacity` is the bin of the dropped choices
            slot_f = slot.reshape(-1)
            slot_tok = torch.zeros(capacity + 1, dtype=torch.long,
                                   device=x.device).scatter(
                0, slot_f, tok_ids.reshape(-1))[:capacity]
            slot_used = torch.zeros(capacity + 1, dtype=dt,
                                    device=x.device).scatter(
                0, slot_f, torch.ones_like(slot_f, dtype=dt))[:capacity]
            slot_gate = torch.zeros(capacity + 1, dtype=torch.float32,
                                    device=x.device).scatter(
                0, slot_f, gsel.reshape(-1).to(torch.float32))[:capacity]
            xe = xin.index_select(0, slot_tok) * slot_used[:, None]
            h = F.silu(dense(xe, wg)) * dense(xe, wu)
            ye = dense(h, wd).to(torch.float32)
            out = out.index_add(0, slot_tok, ye * slot_gate[:, None])
        else:
            # a token picks an expert at most once: one 1 a row, or none
            disp = torch.zeros((t, capacity + 1), dtype=dt,
                               device=x.device).scatter_(
                1, slot, 1.0)[:, :capacity]                     # (t, cap)
            xe = disp.t() @ xin                                 # (cap, d)
            h = F.silu(dense(xe, wg)) * dense(xe, wu)
            ye = dense(h, wd)
            g = gsel.to(torch.float32).sum(dim=1)
            comb = disp.to(torch.float32) @ ye.to(torch.float32)
            out = out + comb * g[:, None]
    out = out.to(dt)
    if outer != "none":
        out = f_reduce(out, ctx)
    # load balance: the fraction routed (top-1) against the mean router
    # probability, per expert.  TP: from the replicated logits (before
    # g_copy); SP: from this rank's shard, averaged over the model axis
    if ctx.tp == 1 and outer != "none":
        probs_aux, idx_aux = probs, idx
    else:
        probs_aux = torch.softmax(aux_logits, dim=-1)
        idx_aux = idx if outer != "none" else \
            torch.topk(probs_aux, k, dim=-1)[1]
    frac = F.one_hot(idx_aux[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * (frac * probs_aux.mean(dim=0)).sum()
    if outer == "none":
        aux = pmean(aux, ctx)
    return out.reshape(b, s, d), aux
