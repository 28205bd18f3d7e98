"""CommPlan — the declarative IR of the collective schedules (the subset
the flat Fig. 3 schedule and the warmup all-reduce need).

A :class:`CommPlan` is a straight-line sequence of typed collective ops.
Every op is annotated with

  * ``payload``  — the wire arrays the op moves, as :class:`WireSpec`
                   (dtype, shape) pairs per rank: exactly the compressor's
                   wire format (``Compressor.wire_specs``), which the
                   executor asserts against what the compressor hands it;
  * ``axes``     — the data-parallel axis the op runs over: ``("dp",)`` is
                   the default ``torch.distributed`` process group, ``()``
                   a degenerate single group, executed as a local round
                   trip;
  * ``n``        — the number of ranks on those axes;
  * ``tier``     — ``"intra"`` or ``"cross"`` (a cost annotation the
                   executor ignores);
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


@dataclasses.dataclass(frozen=True)
class AllReduce(CollectiveOp):
    """Uncompressed reduce over ``axes`` (the warmup exchange)."""

    reduce: str = "mean"

    def validate(self) -> None:
        super().validate()
        if self.reduce not in ("mean", "sum"):
            raise ValueError(f"unknown reduce {self.reduce!r}")


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
