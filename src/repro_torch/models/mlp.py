"""Feed-forward layers at tp=1: gelu (the BERT encoder), SwiGLU (the
decoders), and the MoE layer with capacity-based dispatch, as
``repro/models/mlp.py``.

MoE at tp = 1 (``moe_layout`` = (E, 1, d_ff)): every expert is whole and
local.  The router runs in f32; its softmax's top-k choices, renormalised
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
mean p_e`` over the top-1 choices.  The reference's sequence-parallel
branch (``outer="none"``) belongs to tensor parallelism, not ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["wg"]), approximate="tanh")
    elif cfg.mlp_kind == "swiglu":
        h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
    else:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    return dense(h, p["wd"])


def moe_layout(cfg: ArchConfig, tp: int = 1) -> Tuple[int, int, int]:
    """(experts a rank, ff slices an expert, local d_ff)."""
    if tp != 1:
        raise NotImplementedError("tensor parallelism is not ported")
    return cfg.n_experts, 1, cfg.d_ff


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert holds for ``t`` tokens of this microbatch."""
    return max(int(math.ceil(t * cfg.moe_top_k / cfg.n_experts
                             * cfg.capacity_factor)), 4)


def moe_forward(p, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), aux), aux the layer's Switch
    load-balance loss (f32 scalar)."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    xin = x.reshape(t, d)

    logits = xin.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (t, e)
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
    for j in range(moe_layout(cfg)[0]):
        sel = (idx == j) & keep                                 # (t, k)
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
    # load balance: the fraction routed (top-1) against the mean router
    # probability, per expert
    frac = F.one_hot(idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()
    return out.reshape(b, s, d), aux
