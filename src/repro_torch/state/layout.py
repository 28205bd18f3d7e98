"""Bucket-invariant EF-residual layout: element maps + canonicalisation.

The chunk-sized error-feedback slots (``server``, ``outer``, ``outer_ag``)
hold, per dp rank, the residuals of the elements THAT RANK serves, ordered
by global element index within the served set.  Which elements a rank
serves depends on the pipeline bucket partition: bucket ``b`` of size
``s_b`` at offset ``o_b`` assigns serving rank ``r`` (of ``n_srv``) the
elements

    o_b + r*(s_b/n_srv) + p*(s_b/(n_srv*n_sub)) + j ,   j < s_b/div

(``p`` over ``n_sub`` sub-groups for the hierarchical gather sub-chunk
slots, else absent).  :func:`ef_element_map` writes that map down once.

**Canonical layout** = the serial (one-bucket) keying: position ``p`` of
serving rank ``r`` holds the residual of global element ``r*(d/n_srv) +
p``.  :func:`to_canonical` / :func:`from_canonical` permute a saved global
state between the run layout of any bucket count and that canonical form,
a host-side numpy reindexing.  Checkpoints store the canonical keying,
so a run resumes under any ``--pipeline`` bucket count; the port's
checkpoints and layout manifest are the reference's.

The port's copy of ``repro/state/layout.py`` (numpy only).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     slot_length, state_bytes)


def bucket_sizes_for(d: int, n_total: int, block: int,
                     n_buckets: int) -> Tuple[int, ...]:
    """The bucket partition a run with these parameters executes: the
    pipelined executor's own (``Bucketer.for_exchange``)."""
    if n_buckets <= 1:
        return (d,)
    from repro_torch.pipeline.bucket import Bucketer
    return Bucketer.for_exchange(d, n_total, block, n_buckets).sizes


def ef_element_map(d: int, sizes: Sequence[int], n_srv: int,
                   n_sub: int = 1) -> np.ndarray:
    """Global element index held at each (sub-rank, serving rank, buffer
    position) of a chunk EF slot under bucket partition ``sizes``: an
    int64 array of shape ``(n_sub, n_srv, d // (n_srv*n_sub))`` that is a
    permutation of ``arange(d)``."""
    n_srv = max(n_srv, 1)
    n_sub = max(n_sub, 1)
    div = n_srv * n_sub
    assert sum(sizes) == d and d % div == 0, (sizes, d, div)
    out = np.empty((n_sub, n_srv, d // div), np.int64)
    off = pos = 0
    r = np.arange(n_srv)[None, :, None]
    p = np.arange(n_sub)[:, None, None]
    for s_b in sizes:
        assert s_b % div == 0, (s_b, div)
        lb = s_b // div
        j = np.arange(lb)[None, None, :]
        out[:, :, pos:pos + lb] = off + r * (s_b // n_srv) \
            + p * (s_b // div) + j
        off += s_b
        pos += lb
    return out


def ef_slot_perm(d: int, run_sizes: Sequence[int], n_srv: int,
                 n_sub: int = 1,
                 canonical_sizes: Optional[Sequence[int]] = None
                 ) -> np.ndarray:
    """Flat permutation taking the run layout to the canonical one:
    ``canonical.reshape(-1) == run.reshape(-1)[perm]`` over the
    ``(n_sub, n_srv, L)`` serving block."""
    run = ef_element_map(d, run_sizes, n_srv, n_sub).reshape(-1)
    canon = ef_element_map(d, canonical_sizes or (d,), n_srv,
                           n_sub).reshape(-1)
    perm = np.empty_like(run)
    perm[np.argsort(canon, kind="stable")] = np.argsort(run, kind="stable")
    return perm


def _apply_slot_perm(arr: np.ndarray, perm: np.ndarray, n_rep: int,
                     n_serving: int, tp: int) -> np.ndarray:
    """Permute the trailing ``(n_serving, L)`` serving block of a global
    slot array shaped ``(*dp_sizes, tp, L)``, per replication slice and
    per tp shard."""
    lead = arr.shape
    length = lead[-1]
    a = arr.reshape(n_rep, n_serving, tp, length)
    a = np.moveaxis(a, 2, 1)                       # (n_rep, tp, srv, L)
    a = a.reshape(n_rep, tp, n_serving * length)
    a = a[..., perm]
    a = a.reshape(n_rep, tp, n_serving, length)
    a = np.moveaxis(a, 1, 2)
    return a.reshape(lead)


def canonicalize_state(state: StateTree, slots: Sequence[SlotSpec],
                       ctx: StateLayout, *, n_buckets: int, block: int,
                       to_canonical: bool = True) -> StateTree:
    """Permute every bucket-keyed EF slot of a GLOBAL state tree between
    the run layout of ``n_buckets`` and the canonical serial layout
    (non-bucket-keyed slots pass through untouched)."""
    sizes = bucket_sizes_for(ctx.d, ctx.n_dp, block, n_buckets)
    if len(sizes) == 1:
        return state                          # serial IS canonical
    out = dict(state)
    for spec in slots:
        if not spec.bucket_keyed or spec.name not in out:
            continue
        n_sub = ctx.chunk_divisor(spec.chunk_of) // max(ctx.n_srv, 1)
        n_serving = ctx.n_srv * n_sub
        n_rep = max(ctx.n_dp, 1) // n_serving
        if to_canonical:
            perm = ef_slot_perm(ctx.d, sizes, ctx.n_srv, n_sub)
        else:
            perm = ef_slot_perm(ctx.d, (ctx.d,), ctx.n_srv, n_sub,
                                canonical_sizes=sizes)
        arr = np.asarray(out[spec.name])
        expect = tuple(ctx.dp_sizes) + (ctx.tp, slot_length(spec, ctx))
        assert arr.shape == expect, (spec.name, arr.shape, expect)
        out[spec.name] = _apply_slot_perm(arr, perm, n_rep, n_serving,
                                          ctx.tp)
    return StateTree(out)


def to_canonical(state: StateTree, slots: Sequence[SlotSpec],
                 ctx: StateLayout, *, n_buckets: int,
                 block: int) -> StateTree:
    return canonicalize_state(state, slots, ctx, n_buckets=n_buckets,
                              block=block, to_canonical=True)


def from_canonical(state: StateTree, slots: Sequence[SlotSpec],
                   ctx: StateLayout, *, n_buckets: int,
                   block: int) -> StateTree:
    return canonicalize_state(state, slots, ctx, n_buckets=n_buckets,
                              block=block, to_canonical=False)


def layout_manifest(slots: Sequence[SlotSpec], ctx: StateLayout, *,
                    block: int,
                    bucket_counts: Sequence[int] = (1, 2, 4)
                    ) -> Dict[str, object]:
    """Deterministic description of the materialised state layout: slot
    table, per-rank lengths/bytes, and a checksum of the run->canonical
    permutation per bucket count."""
    table = []
    for s in slots:
        row = s.manifest()
        row["length"] = slot_length(s, ctx)
        table.append(row)
    perms = {}
    for nb in bucket_counts:
        sizes = bucket_sizes_for(ctx.d, ctx.n_dp, block, nb)
        sig = {}
        for s in slots:
            if not s.bucket_keyed:
                continue
            n_sub = ctx.chunk_divisor(s.chunk_of) // max(ctx.n_srv, 1)
            perm = ef_slot_perm(ctx.d, sizes, ctx.n_srv, n_sub)
            sig[s.name] = hashlib.sha256(perm.tobytes()).hexdigest()[:16]
        perms[str(len(sizes))] = {"bucket_sizes": list(sizes),
                                  "perm_sha256_16": sig}
    return {"ctx": {"d": ctx.d, "n_dp": ctx.n_dp, "n_srv": ctx.n_srv,
                    "n_outer": ctx.n_outer,
                    "n_segments": ctx.n_segments,
                    "dp_sizes": list(ctx.dp_sizes), "tp": ctx.tp,
                    "block": block},
            "slots": table,
            "state_bytes_per_rank": state_bytes(slots, ctx),
            "bucketed_layouts": perms}


def manifest_json(manifest: Dict[str, object]) -> str:
    return json.dumps(manifest, indent=2, sort_keys=True)
