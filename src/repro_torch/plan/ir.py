"""CommPlan — the declarative IR of the collective schedules: the ops of
the flat Fig. 3 schedule, the hierarchical two-level schedule and the
warmup all-reduce, and ``ReduceScatter`` / ``Broadcast``, which the cost
model prices (``repro_torch.plan.cost``) and no schedule of the executor
runs yet.

A :class:`CommPlan` is a straight-line sequence of typed collective ops.
Every op is annotated with

  * ``payload``  — the wire arrays the op moves, as :class:`WireSpec`
                   (dtype, shape) pairs per rank: exactly the compressor's
                   wire format (``Compressor.wire_specs``), which the
                   executor asserts against what the compressor hands it;
  * ``axes``     — the mesh axes the op runs over, which the executor
                   maps to a ``torch.distributed`` process group
                   (``repro_torch.launch.mesh``); ``()`` is a degenerate
                   single group, executed as a local round trip;
  * ``n``        — the number of ranks on those axes;
  * ``tier``     — ``"intra"`` or ``"cross"`` (the link the op crosses:
                   a cost annotation that both executors ignore);
  * ``err_slot`` — the error-feedback buffer consumed and produced at the
                   op's compress point (``None`` = plain compression).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

TIERS = ("intra", "cross")


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """One payload leaf on the wire: dtype name + per-rank shape."""

    dtype: str
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * np.dtype(self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One hop of a schedule.  ``d_in`` is the length of the represented
    f32 vector entering the op; ``payload`` is what it looks like on the
    wire after this op's compress point."""

    axes: Tuple[str, ...]
    n: int
    tier: str
    payload: Tuple[WireSpec, ...]
    d_in: int
    err_slot: Optional[str] = None

    @property
    def d_out(self) -> int:
        return self.d_in

    @property
    def kind(self) -> str:
        return type(self).__name__

    @property
    def payload_bytes(self) -> int:
        """Per-rank operand bytes (what the rank hands the collective)."""
        return sum(ws.nbytes for ws in self.payload)

    @property
    def wire_send_bytes(self) -> float:
        """Bytes one rank puts on the wire (ring/pairwise)."""
        raise NotImplementedError

    @property
    def hlo_bytes(self) -> float:
        """Collective bytes as the reference's roofline counts them
        (all-to-all: 1x operand; all-gather: 1x result; all-reduce: 2x
        operand), kept so pipelined and serial plans can be held to the
        same totals."""
        raise NotImplementedError

    def validate(self) -> None:
        if self.tier not in TIERS or self.n < 1 or self.d_in < 1:
            raise ValueError(f"invalid op {self}")
        for ws in self.payload:
            if len(ws.shape) < 1 or any(s < 0 for s in ws.shape):
                raise ValueError(f"invalid payload leaf {ws}")


@dataclasses.dataclass(frozen=True)
class AllToAll(CollectiveOp):
    """Chunk exchange + local combine: every rank splits each payload leaf
    into ``n`` leading chunks, sends chunk j to rank j, then decompresses
    the ``n`` received chunks and combines them (Fig. 3a+3b).  Value
    length: ``d_in -> d_in // n``."""

    combine: str = "mean"

    @property
    def d_out(self) -> int:
        return self.d_in // max(self.n, 1)

    @property
    def wire_send_bytes(self) -> float:
        return self.payload_bytes * (self.n - 1) / max(self.n, 1)

    @property
    def hlo_bytes(self) -> float:
        return float(self.payload_bytes)

    def validate(self) -> None:
        super().validate()
        if self.combine not in ("mean", "sum"):
            raise ValueError(f"unknown combine {self.combine!r}")
        for ws in self.payload:
            if ws.shape[0] % max(self.n, 1):
                raise ValueError(f"all_to_all payload leaf {ws} does not "
                                 f"chunk evenly over {self.n} ranks")


@dataclasses.dataclass(frozen=True)
class AllGather(CollectiveOp):
    """Gather every rank's (compressed) chunk and decompress the full
    vector (Fig. 3c).  Value length: ``d_in -> d_in * n``."""

    @property
    def d_out(self) -> int:
        return self.d_in * max(self.n, 1)

    @property
    def wire_send_bytes(self) -> float:
        # ring all-gather: each rank forwards its chunk n-1 times
        return float(self.payload_bytes * (self.n - 1))

    @property
    def hlo_bytes(self) -> float:
        return float(self.payload_bytes * max(self.n, 1))


@dataclasses.dataclass(frozen=True)
class AllReduce(CollectiveOp):
    """Uncompressed reduce over ``axes`` (the warmup exchange)."""

    reduce: str = "mean"

    @property
    def wire_send_bytes(self) -> float:
        # ring: reduce-scatter + all-gather, each (n-1)/n of the buffer
        return 2.0 * self.payload_bytes * (self.n - 1) / max(self.n, 1)

    @property
    def hlo_bytes(self) -> float:
        return 2.0 * self.payload_bytes

    def validate(self) -> None:
        super().validate()
        if self.reduce not in ("mean", "sum"):
            raise ValueError(f"unknown reduce {self.reduce!r}")


@dataclasses.dataclass(frozen=True)
class ReduceScatter(CollectiveOp):
    """Reduce + scatter: each rank keeps its reduced chunk.  Value length:
    ``d_in -> d_in // n``."""

    reduce: str = "mean"

    @property
    def d_out(self) -> int:
        return self.d_in // max(self.n, 1)

    @property
    def wire_send_bytes(self) -> float:
        return self.payload_bytes * (self.n - 1) / max(self.n, 1)

    @property
    def hlo_bytes(self) -> float:
        return float(self.payload_bytes)

    def validate(self) -> None:
        super().validate()
        if self.reduce not in ("mean", "sum"):
            raise ValueError(f"unknown reduce {self.reduce!r}")
        if self.d_in % max(self.n, 1):
            raise ValueError(f"reduce_scatter: d_in={self.d_in} does not "
                             f"split over {self.n} ranks")


@dataclasses.dataclass(frozen=True)
class Broadcast(CollectiveOp):
    """One-to-all from rank ``root`` of ``axes`` (a tree: log2(n) rounds)."""

    root: int = 0

    @property
    def wire_send_bytes(self) -> float:
        return float(self.payload_bytes)

    @property
    def hlo_bytes(self) -> float:
        return float(self.payload_bytes)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A named, validated sequence of collective ops.  ``d`` is the
    represented f32 vector length entering the plan; ``err_slots`` names
    the EF buffers the plan consumes."""

    name: str
    d: int
    ops: Tuple[CollectiveOp, ...]

    @property
    def err_slots(self) -> Tuple[str, ...]:
        out = []
        for op in self.ops:
            if op.err_slot is not None and op.err_slot not in out:
                out.append(op.err_slot)
        return tuple(out)

    def validate(self) -> "CommPlan":
        d = self.d
        for op in self.ops:
            op.validate()
            if op.d_in != d:
                raise ValueError(f"plan {self.name!r}: op {op.kind} expects "
                                 f"d_in={op.d_in}, previous op left d={d}")
            d = op.d_out
        return self

    def hlo_bytes(self, tier: Optional[str] = None) -> float:
        return sum(op.hlo_bytes for op in self.ops
                   if tier is None or op.tier == tier)

    def wire_send_bytes(self, tier: Optional[str] = None) -> float:
        """Bytes one rank puts on the wire executing the plan."""
        return sum(op.wire_send_bytes for op in self.ops
                   if tier is None or op.tier == tier)

    def describe(self) -> str:
        lines = [f"CommPlan {self.name!r} (d={self.d})"]
        for op in self.ops:
            leaves = ", ".join(f"{w.dtype}{list(w.shape)}"
                               for w in op.payload)
            ef = f" ef={op.err_slot}" if op.err_slot else ""
            lines.append(
                f"  {op.kind:13s} axes={op.axes} n={op.n} tier={op.tier}"
                f" d={op.d_in}->{op.d_out} [{leaves}]{ef}")
        return "\n".join(lines)


def log2ceil(n: int) -> int:
    """ceil(log2(n)) for n > 1, else 0: the rounds of a tree collective."""
    return (int(n) - 1).bit_length() if n > 1 else 0
