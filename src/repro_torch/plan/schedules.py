"""Plan builders: the paper's Fig. 3 schedule, the hierarchical two-level
schedule and the warmup all-reduce as
:class:`~repro_torch.plan.ir.CommPlan`s (counterpart of
``repro/plan/schedules.py``).

Builders take the compressor (for ``wire_specs``) plus static sizes and
axis names; they never touch tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll, CommPlan,
                                 WireSpec)


def _f32(d: int) -> Tuple[WireSpec, ...]:
    return (WireSpec("float32", (d,)),)


def needs_outer_ef(comp) -> bool:
    """Sparse (coordinate-dropping) compressors need error feedback on
    every lossy hop: the hierarchical cross-pod legs are EF-free for dense
    compressors (their residual is O(eps/n_pods) and does not accumulate)
    but would drop the sub-threshold coordinates of a sparse one for good,
    so those get the ``outer`` / ``outer_ag`` EF slots."""
    return not comp.dense and not comp.lossless


def flat_schedule(comp, d: int, n: int, axes: Sequence[str],
                  tier: str = "intra") -> CommPlan:
    """The paper's Fig. 3 schedule: worker EF-compress -> all_to_all ->
    local average -> server EF-compress -> all_gather."""
    axes = tuple(axes)
    n = max(n, 1)
    if d % n:
        raise ValueError(f"flat schedule: d={d} does not split over {n}")
    chunk = d // n
    ops = (
        AllToAll(axes=axes, n=n, tier=tier, payload=comp.wire_specs(d),
                 d_in=d, err_slot="worker"),
        AllGather(axes=axes, n=n, tier=tier, payload=comp.wire_specs(chunk),
                  d_in=chunk, err_slot="server"),
    )
    return CommPlan(name=f"flat/{comp.name}", d=d, ops=ops).validate()


def hier_schedule(comp, d: int, n_inner: int, n_outer: int,
                  inner_axes: Sequence[str], outer_axes: Sequence[str],
                  outer_ef: bool = False) -> CommPlan:
    """Two-level schedule: the paper's server stage within the pod (intra
    tier) and the cross-pod hop at server-chunk granularity (cross tier).

    A lossless compressor takes a plain cross-pod all-reduce of the chunk;
    a lossy dense one runs EF-free compressed legs (all_to_all of the
    chunk, all_gather of the sub-chunk); a sparse one needs
    ``outer_ef=True``, which gives the all_to_all leg the ``outer`` slot
    (one (d/n_inner,) buffer a rank) and the all_gather leg the
    ``outer_ag`` slot (one (d/(n_inner*n_outer),) buffer a rank).  Each
    slot is read and written by the same rank for the same global
    elements, so the EF arithmetic does not depend on the pipeline's
    bucket partition."""
    inner_axes, outer_axes = tuple(inner_axes), tuple(outer_axes)
    n_inner, n_outer = max(n_inner, 1), max(n_outer, 1)
    if d % (n_inner * n_outer):
        raise ValueError(f"hier schedule: d={d} does not split over "
                         f"{n_inner} x {n_outer}")
    chunk = d // n_inner
    sub = chunk // n_outer
    ops = [AllToAll(axes=inner_axes, n=n_inner, tier="intra",
                    payload=comp.wire_specs(d), d_in=d, err_slot="worker")]
    if comp.lossless:
        ops.append(AllReduce(axes=outer_axes, n=n_outer, tier="cross",
                             payload=_f32(chunk), d_in=chunk))
    else:
        ops.append(AllToAll(axes=outer_axes, n=n_outer, tier="cross",
                            payload=comp.wire_specs(chunk), d_in=chunk,
                            err_slot="outer" if outer_ef else None))
        ops.append(AllGather(axes=outer_axes, n=n_outer, tier="cross",
                             payload=comp.wire_specs(sub), d_in=sub,
                             err_slot="outer_ag" if outer_ef else None))
    ops.append(AllGather(axes=inner_axes, n=n_inner, tier="intra",
                         payload=comp.wire_specs(chunk), d_in=chunk,
                         err_slot="server"))
    name = f"hier/{comp.name}" + ("+outer_ef" if outer_ef else "")
    return CommPlan(name=name, d=d, ops=tuple(ops)).validate()


def allreduce_schedule(d: int, n: int, axes: Sequence[str],
                       tier: str = "intra") -> CommPlan:
    """Uncompressed dp-mean (the warmup stage)."""
    return CommPlan(
        name="allreduce", d=d,
        ops=(AllReduce(axes=tuple(axes), n=max(n, 1), tier=tier,
                       payload=_f32(d), d_in=d),)).validate()
