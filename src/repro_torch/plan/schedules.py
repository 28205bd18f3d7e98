"""Plan builders: the paper's Fig. 3 schedule and the warmup all-reduce as
:class:`~repro_torch.plan.ir.CommPlan`s (counterpart of
``repro/plan/schedules.py``; the hierarchical schedule is a later slice).

Builders take the compressor (for ``wire_specs``) plus static sizes and
axis names; they never touch tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll, CommPlan,
                                 WireSpec)


def _f32(d: int) -> Tuple[WireSpec, ...]:
    return (WireSpec("float32", (d,)),)


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


def allreduce_schedule(d: int, n: int, axes: Sequence[str],
                       tier: str = "intra") -> CommPlan:
    """Uncompressed dp-mean (the warmup stage)."""
    return CommPlan(
        name="allreduce", d=d,
        ops=(AllReduce(axes=tuple(axes), n=max(n, 1), tier=tier,
                       payload=_f32(d), d_in=d),)).validate()
