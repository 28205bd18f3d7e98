"""State-aware checkpointing: the reference's global layout, canonical EF
keying and slot-diff migration.

``repro_torch.checkpoint.io`` stays a generic npz pytree store; this
module is the slot-declaration-driven layer ``launch/train.py`` uses.  A
checkpoint holds ``(params, state)`` exactly as the reference's
``repro.state.checkpoint`` writes it — the reference's nested parameter
tree and one GLOBAL array per state slot (``(*dp_sizes, tp, L)`` for
per-dp-rank and dp-sharded slots, ``(tp, L)`` for replicated ones) — so a
checkpoint written by either package loads in the other:

  * **save** — every per-rank slot is gathered from the dp ranks to rank
    0, which writes; bucket-keyed EF slots are permuted to the canonical
    (serial) keying and the meta records ``ef_layout="canonical"``;
  * **load** — every rank reads the archive into the declared zeros
    template, takes its own slice of each per-rank slot, and names the
    slots the archive predates (they start at zeros).
"""
from __future__ import annotations

import warnings
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import load_meta, load_pytree, save_pytree
from repro_torch.convert import (params_from_jax, params_to_jax,
                                 state_from_global, state_to_global)
from repro_torch.plan.executor import _all_gather_into
from repro_torch.state.layout import from_canonical, to_canonical
from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     global_shapes)

EF_LAYOUT_CANONICAL = "canonical"


def slot_diff(state_template: Mapping, archive_keys: Sequence[str]
              ) -> Tuple[str, ...]:
    """Slots the declarations name that the archive predates."""
    present = set()
    for k in archive_keys:
        leaf = k.split("|")[-1]
        present.add(leaf[1:] if leaf.startswith(".") else leaf)
    return tuple(n for n in state_template if n not in present)


def _rank_states(state: StateTree, slots: Sequence[SlotSpec],
                 ctx: StateLayout, dp_axes: Sequence[str]):
    """Every rank's state (rank order): per-rank slots gathered over the
    dp ranks, the rest this rank's."""
    n = max(ctx.n_dp, 1)
    if not dp_axes:
        return [state]
    per_rank = {}
    for s in slots:
        if s.extent != "scalar" and s.replication != "replicated":
            t = state[s.name].contiguous()
            out = torch.empty((n * t.shape[0],), dtype=t.dtype,
                              device=t.device)
            _all_gather_into(out, t)
            per_rank[s.name] = out.view(n, -1)
    return [StateTree({k: per_rank[k][r] if k in per_rank else v
                       for k, v in state.items()}) for r in range(n)]


def save_train_state(path: str, params: Mapping[str, torch.Tensor],
                     state: StateTree, step: int, *,
                     slots: Sequence[SlotSpec], ctx: StateLayout,
                     n_buckets: int, block: int,
                     extra_meta: dict = None,
                     dp_axes: Sequence[str] = ()) -> None:
    """Save the port's dotted ``params`` and this rank's ``state`` in the
    reference's global layout; rank 0 writes (every rank must call)."""
    glob = state_to_global(_rank_states(state, slots, ctx, dp_axes), slots,
                           ctx)
    if not dp_axes or dist.get_rank() == 0:
        canon = to_canonical(glob, slots, ctx, n_buckets=n_buckets,
                             block=block)
        meta = {"ef_layout": EF_LAYOUT_CANONICAL,
                "n_buckets": int(n_buckets), "block": int(block),
                **(extra_meta or {})}
        save_pytree(path, (params_to_jax(params), canon), step, meta=meta)
    if dp_axes:
        dist.barrier()


def load_train_state(path: str, params_template: Mapping[str, torch.Tensor],
                     state_template: StateTree, *,
                     slots: Sequence[SlotSpec], ctx: StateLayout,
                     n_buckets: int, block: int, rank: int = 0
                     ) -> Tuple[Tuple[dict, StateTree], int]:
    """Restore ``(params, state)`` of rank ``rank``: the port's dotted f32
    params (on the CPU) and this rank's state tensors on the template's
    device; returns ``((params, state), step)``."""
    meta = load_meta(path)
    with np.load(path) as data:
        archive_keys = [k for k in data.files if not k.startswith("__")]
    missing = slot_diff(state_template, archive_keys)
    if missing:
        warnings.warn(
            f"checkpoint {path} predates state slots {sorted(missing)}; "
            "they resume from their zeros template (slot declaration diff)")
    # zero-stride zeros: a shape and dtype, no memory
    glob_template = global_shapes(slots, ctx).map(
        lambda sd: np.broadcast_to(np.zeros((), sd[1]), sd[0]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # io's generic key warning
        (params, glob), step = load_pytree(
            path, (_params_template(params_template), glob_template),
            backfill=True)
    saved_nb = int(meta.get("n_buckets", 1))
    if meta.get("ef_layout") != EF_LAYOUT_CANONICAL and saved_nb > 1:
        # bucket-major era checkpoint: lift to canonical first
        glob = to_canonical(glob, slots, ctx, n_buckets=saved_nb,
                            block=int(meta.get("block", block)))
    glob = from_canonical(glob, slots, ctx, n_buckets=n_buckets, block=block)
    device = next(iter(state_template.values())).device
    state = state_from_global(glob, slots, ctx, rank=rank, device=device)
    return (params_from_jax(params), state), step


def _params_template(params: Mapping[str, torch.Tensor]) -> dict:
    """The reference's nested parameter tree with zero-stride f32 leaves of
    the params' shapes: a load template that copies nothing."""
    return params_to_jax({p: torch.zeros(()).expand(t.shape)
                          for p, t in params.items()})
