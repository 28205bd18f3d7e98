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

The dropless layer (``dropless_moe_forward``, ``cfg.moe_kind ==
"dropless"``: DeepSeek-V3's, tp 1) holds experts ``expert_first ..
expert_first + n_held - 1`` of ``n_experts`` (the chip's share of an
expert-parallel deployment) and computes their part of the layer; its
router keeps every expert and its top-k.  In float32: s = sigmoid(x
router), the top k of s + b chosen, ties by the larger logit (b the
layer's selection bias, a buffer outside the flat parameters: zero, and
never updated here, as in DeepSeek-V3's last phase, whose bias update
speed is 0), the gates the chosen s over their sum, times
``moe_gate_scale``.  No token is dropped:
each (token, choice) whose expert is held takes a row of a static buffer
of T * k rows, in expert order and token order within an expert, all
computed on the device (``route``).  The held experts' SwiGLUs are
grouped products over the filled rows (``torch._grouped_mm`` with the
rows' end offsets), the rows move through ``kernels.moe_dispatch``
(permute, and the gated combine in choice order) and the shared experts,
one SwiGLU of ``n_shared_experts * moe_d_ff``, see every token whole.
Its auxiliary loss is DeepSeek-V3's sequence-wise balance term, a
sequence's ``sum_e f_e P_e`` averaged over the batch, with f_e = E /
(k S) times the sequence's tokens routed to e and P_e the mean over the
sequence of s_e / sum_j s_j (the chosen experts stand for the paper's
top k of s, which they are while b is zero).  Nothing in it reads the
device from the host.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_dispatch import ops as dispatch
from repro_torch.models.common import (NO_TP, ParallelCtx, dense, f_reduce,
                                       g_copy, pmean, rep_param, sp_gather,
                                       tp_rank)
from repro_torch.obs.trace import (DISPATCH_SPAN, MOE_SPAN, count_device,
                                   scope, tracing_enabled)

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


# --------------------------------------------------------------------------
# the dropless layer (DeepSeek-V3)
# --------------------------------------------------------------------------

# the dim of each leaf split over the model axis (the layer runs at tp 1)
DROPLESS_SPECS = {"router": None, "shared_wd": 0, "shared_wg": 1,
                  "shared_wu": 1, "wd": 0, "wg": 0, "wu": 0}


def dropless_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one dropless layer's leaves: the router over every
    expert, the held experts' stacks, the shared experts' SwiGLU."""
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_held
    out = {"router": (d, cfg.n_experts), "wg": (e, d, f), "wu": (e, d, f),
           "wd": (e, f, d)}
    fs = cfg.n_shared_experts * f
    if fs:
        out.update(shared_wg=(d, fs), shared_wu=(d, fs), shared_wd=(fs, d))
    return out


def dropless_param_specs(cfg: ArchConfig) -> Dict[str, Optional[int]]:
    return {k: DROPLESS_SPECS[k] for k in dropless_shapes(cfg)}


class Route(NamedTuple):
    """Where a batch's (token, choice) pairs go: ``gates`` (T, k) f32
    (differentiable), ``chosen`` (T, k) the experts, ``scores`` (T, E) the
    sigmoid scores, ``pair`` (T * k,) int32 the pair ``t * k + j`` in each
    row of the routed buffer (-1: empty), ``slot`` (T, k) int32 the row of
    each pair (-1: its expert is held elsewhere), ``counts`` and ``offs``
    (n_held,) the rows of each held expert and their running sum."""
    gates: torch.Tensor
    chosen: torch.Tensor
    scores: torch.Tensor
    pair: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    offs: torch.Tensor


def choose(key: torch.Tensor, logits: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest of ``key`` (T, E) in each row, largest first, ties
    broken by the larger logit: s rounds to 1.0 in float32 above a logit of
    ~16.6, and the logit keeps the order of the unrounded s (topk's own
    tie-break, the lower expert index, would hand every such token to the
    lowest experts)."""
    by_logit = torch.argsort(logits, dim=-1, descending=True, stable=True)
    o = torch.argsort(key.gather(1, by_logit), dim=-1, descending=True,
                      stable=True)
    return by_logit.gather(1, o[:, :k])


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          cfg: ArchConfig) -> Route:
    """The dropless layer's routing of x (T, d) on the device (see the
    module doc): the expert order is a stable sort of the held experts'
    indices, so the rows of one expert keep their token order."""
    t, k, e_h = x.shape[0], cfg.moe_top_k, cfg.n_held
    dev = x.device
    logits = x.to(torch.float32) @ router.to(torch.float32)
    scores = torch.sigmoid(logits)
    chosen = choose(scores.detach() + bias, logits.detach(), k)
    g = scores.gather(1, chosen)
    gates = g / (g.sum(dim=-1, keepdim=True) + 1e-20) * cfg.moe_gate_scale
    local = chosen - cfg.expert_first
    held = ((local >= 0) & (local < e_h)).reshape(-1)
    key = torch.where(held, local.reshape(-1), e_h)
    order = torch.argsort(key, stable=True)
    counts = (key[:, None] == torch.arange(e_h, device=dev)).sum(dim=0)
    offs = torch.cumsum(counts, dim=0).to(torch.int32)
    rows = torch.arange(t * k, device=dev)
    pair = torch.where(rows < offs[-1], order, -1).to(torch.int32)
    slot = torch.empty_like(order).scatter_(0, order, rows)
    slot = torch.where(held, slot, -1).to(torch.int32).view(t, k)
    return Route(gates, chosen, scores, pair, slot, counts, offs)


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
             ) -> torch.Tensor:
    """Rows ``offs[e-1] .. offs[e]`` of x times expert e's w, in x's
    dtype; rows past ``offs[-1]`` are left undefined."""
    return torch._grouped_mm(x, w.to(x.dtype), offs=offs)


def seq_balance_loss(rt: Route, b: int, cfg: ArchConfig) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance term of one layer (see the
    module doc), f32 scalar."""
    e, k = cfg.n_experts, cfg.moe_top_k
    s = rt.scores.shape[0] // b
    hit = torch.zeros_like(rt.scores).scatter_(1, rt.chosen, 1.0)
    f = hit.view(b, s, e).sum(dim=1) * (e / (k * s))
    p = (rt.scores / rt.scores.sum(dim=-1, keepdim=True)).view(b, s, e)
    return (f * p.mean(dim=1)).sum(dim=-1).mean()


def dropless_moe_forward(p, x: torch.Tensor, cfg: ArchConfig,
                         bias: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), aux): the held experts' gated part of
    the layer plus the shared experts, and the balance term; inside a
    ``model.moe`` range, the route and the dispatch kernels inside
    ``model.moe.dispatch`` (tracing on)."""
    b, s, d = x.shape
    k = cfg.moe_top_k
    with scope(MOE_SPAN):
        x2 = x.reshape(b * s, d)
        with scope(DISPATCH_SPAN):
            rt = route(x2, p["router"], bias, cfg)
            xp = dispatch.permute(x2, rt.pair, rt.slot, k)
        h = F.silu(_grouped(xp, p["wg"], rt.offs)) \
            * _grouped(xp, p["wu"], rt.offs)
        ye = _grouped(h, p["wd"], rt.offs)
        with scope(DISPATCH_SPAN):
            y = dispatch.combine(ye, rt.gates, rt.pair, rt.slot, k)
        if "shared_wg" in p:
            y = y + dense(F.silu(dense(x2, p["shared_wg"]))
                          * dense(x2, p["shared_wu"]), p["shared_wd"])
        if tracing_enabled():       # no counting kernel with tracing off
            count_device("moe.rows", rt.offs[-1])
            count_device("moe.max_rows", rt.counts.max(), op="max")
        return y.view(b, s, d), seq_balance_loss(rt, b, cfg)
