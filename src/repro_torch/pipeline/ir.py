"""PipelinedPlan — a CommPlan lowered onto buckets, with the stage and
stream dependencies of a software pipeline.

``lower_to_pipelined`` takes a straight-line :class:`~repro_torch.plan.ir
.CommPlan` and a :class:`~repro_torch.pipeline.bucket.Bucketer` and makes
one re-specialised sub-plan per bucket (the same op sequence, every
``d_in`` and payload scaled to the bucket), arranged on a (bucket x
stage) grid with the edges

  * ``(b, s) <- (b, s-1)`` — a bucket runs its own ops in order;
  * ``(b, s) <- (b-1, s)`` — a stage is one resource: the link of its
    tier carries one bucket at a time, in bucket order.

Nothing else is ordered: bucket *i*'s cross-pod leg is independent of
bucket *i+1*'s compress and intra-pod leg, which is the overlap the
pipelined executor (:mod:`repro_torch.pipeline.executor`) exposes.  Each
op's *stream* is its link tier.

Re-specialising an op is mechanical because payloads are declarative: a
leaf that is the compressor's wire format for ``d_in`` becomes the wire
format for the bucket's ``d_in``; a raw float32 leaf scales directly.  A
payload that is neither refuses to lower.  The per-bucket wire formats of
a block-aligned bucketing add up to the serial one, so
``PipelinedPlan.hlo_bytes() == plan.hlo_bytes()``.

Each bucket carries its per-op (pre, post)
:class:`~repro_torch.perf.kernel_cost.ComputeSpec` pair
(``repro_torch.plan.cost.op_compute``) in ``BucketPlan.compute``, so the
cost model schedules the compute stream without deriving anything at
pricing time; the executor never reads it.

The port's copy of ``repro/pipeline/ir.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.pipeline.bucket import Bucketer
from repro_torch.plan.cost import op_compute
from repro_torch.plan.ir import CollectiveOp, CommPlan, WireSpec


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One bucket's slice of the exchange: offset/size into the flat
    vector and the re-specialised serial plan that moves it."""

    index: int
    offset: int
    size: int
    plan: CommPlan
    compute: Tuple = ()   # ((pre, post) ComputeSpec) per op, or ()


@dataclasses.dataclass(frozen=True)
class PipelinedPlan:
    """A CommPlan lowered onto buckets (see module docstring)."""

    name: str
    d: int
    buckets: Tuple[BucketPlan, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_stages(self) -> int:
        return len(self.buckets[0].plan.ops)

    @property
    def streams(self) -> Tuple[str, ...]:
        """Per-stage stream (= link tier)."""
        return tuple(op.tier for op in self.buckets[0].plan.ops)

    @property
    def err_slots(self) -> Tuple[str, ...]:
        return self.buckets[0].plan.err_slots

    def edges(self) -> Iterator[Tuple[Tuple[int, int], Tuple[int, int]]]:
        """Dependency edges ((b, s) <- pred) of the pipeline grid."""
        for b in range(self.n_buckets):
            for s in range(self.n_stages):
                if s > 0:
                    yield (b, s), (b, s - 1)
                if b > 0:
                    yield (b, s), (b - 1, s)

    def issue_order(self, order: Optional[Tuple[int, ...]] = None
                    ) -> Iterator[Tuple[int, int]]:
        """(bucket, stage) pairs in wavefront (tick) order: at tick t stage
        s of position t-s issues.  ``order`` (a bucket permutation) runs
        the same wavefront over its positions: position ``p`` carries
        bucket ``order[p]`` (backward overlap passes the order backward
        completes the buckets).  Only the order changes, never a bucket's
        contents."""
        n_b = self.n_buckets
        if order is None:
            seq: Tuple[int, ...] = tuple(range(n_b))
        else:
            seq = tuple(order)
            if sorted(seq) != list(range(n_b)):
                raise ValueError(f"order {seq} is not a permutation of "
                                 f"the {n_b} buckets")
        for tick in range(n_b + self.n_stages - 1):
            for s in range(self.n_stages):
                p = tick - s
                if 0 <= p < n_b:
                    yield seq[p], s

    def slot_lengths(self) -> Dict[str, Tuple[int, ...]]:
        """Per-bucket EF-slot lengths, keyed by slot name."""
        return {slot: tuple(_slot_len(bp.plan, slot) for bp in self.buckets)
                for slot in self.err_slots}

    def slot_strides(self) -> Dict[str, int]:
        """Elements of the flat vector per EF-slot element: bucket b's
        slice of slot ``s`` is ``[offset // stride, (offset + size) //
        stride)``."""
        out: Dict[str, int] = {}
        for slot, lens in self.slot_lengths().items():
            strides = {bp.size // ln for bp, ln in zip(self.buckets, lens)}
            if len(strides) != 1:
                raise ValueError(f"slot {slot!r}: buckets disagree on its "
                                 f"stride {sorted(strides)}")
            out[slot] = strides.pop()
        return out

    def validate(self) -> "PipelinedPlan":
        if not self.buckets:
            raise ValueError("a pipelined plan needs at least one bucket")
        off, kinds = 0, None
        for bp in self.buckets:
            if bp.offset != off or bp.plan.d != bp.size:
                raise ValueError(f"bucket {bp.index}: offset {bp.offset} / "
                                 f"size {bp.size} (plan d {bp.plan.d}) do "
                                 f"not continue at {off}")
            if len(bp.compute) not in (0, len(bp.plan.ops)):
                raise ValueError("compute annotations must cover every op "
                                 "or none")
            bp.plan.validate()
            ks = tuple((op.kind, op.tier, op.err_slot)
                       for op in bp.plan.ops)
            if kinds is not None and ks != kinds:
                raise ValueError(f"buckets must share one op sequence: "
                                 f"{kinds} vs {ks}")
            kinds = ks
            off += bp.size
        if off != self.d:
            raise ValueError(f"buckets cover {off} of d={self.d}")
        self.slot_strides()
        return self

    # --- byte accounting (equal to the serial plan's) --------------------
    def hlo_bytes(self, tier: Optional[str] = None) -> float:
        return sum(bp.plan.hlo_bytes(tier) for bp in self.buckets)

    def wire_send_bytes(self, tier: Optional[str] = None) -> float:
        return sum(bp.plan.wire_send_bytes(tier) for bp in self.buckets)

    def describe(self) -> str:
        lines = [f"PipelinedPlan {self.name!r} (d={self.d}, "
                 f"{self.n_buckets} buckets x {self.n_stages} stages, "
                 f"streams={list(self.streams)})"]
        for bp in self.buckets:
            lines.append(f" bucket {bp.index} [{bp.offset}:"
                         f"{bp.offset + bp.size}]")
            lines.extend("  " + ln
                         for ln in bp.plan.describe().splitlines()[1:])
        return "\n".join(lines)


def _slot_len(plan: CommPlan, slot: str) -> int:
    """EF-buffer length a plan needs for ``slot``: the incoming value
    length of the op that consumes it."""
    for op in plan.ops:
        if op.err_slot == slot:
            return op.d_in
    raise KeyError(f"plan {plan.name!r} has no err slot {slot!r}")


def _rebucket_op(op: CollectiveOp, comp, d: int, d_b: int) -> CollectiveOp:
    """Re-specialise one op from the full exchange (``d``) to a bucket
    (``d_b``); payloads follow the compressor's declared wire format."""
    if op.d_in * d_b % d:
        raise ValueError(f"{op.kind}: d_in={op.d_in} does not scale to "
                         f"bucket {d_b}/{d}")
    d_in_b = op.d_in * d_b // d
    raw = (WireSpec("float32", (op.d_in,)),)
    if comp is not None and op.payload == tuple(comp.wire_specs(op.d_in)):
        payload = tuple(comp.wire_specs(d_in_b))
    elif op.payload == raw:
        payload = (WireSpec("float32", (d_in_b,)),)
    else:
        raise ValueError(
            f"cannot lower {op.kind} to buckets: payload {op.payload} is "
            f"neither the compressor wire format for d={op.d_in} nor raw "
            "float32 — give the op a linear wire format or keep it serial")
    return dataclasses.replace(op, d_in=d_in_b, payload=payload)


def lower_to_pipelined(plan: CommPlan, comp, bucketer: Bucketer,
                       use_kernel: bool = False) -> PipelinedPlan:
    """Lower ``plan`` onto ``bucketer``'s partition (see module doc).
    Each bucket's compute annotations price the fused kernel path with
    ``use_kernel`` (what a CUDA tensor runs), else the unfused chain."""
    if bucketer.d != plan.d:
        raise ValueError(f"bucketer d={bucketer.d} != plan d={plan.d}")
    buckets = []
    for i, (off, size) in enumerate(zip(bucketer.offsets, bucketer.sizes)):
        ops = tuple(_rebucket_op(op, comp, plan.d, size)
                    for op in plan.ops)
        sub = CommPlan(name=f"{plan.name}@b{i}", d=size, ops=ops).validate()
        compute = tuple(op_compute(op, comp, use_kernel) for op in ops)
        buckets.append(BucketPlan(index=i, offset=off, size=size, plan=sub,
                                  compute=compute))
    return PipelinedPlan(name=f"pipe({plan.name})x{len(buckets)}",
                         d=plan.d, buckets=tuple(buckets)).validate()
