"""Pipelined executor — run a :class:`~repro_torch.pipeline.ir.PipelinedPlan`
on this rank's flat value, one bucket's collective in flight while the
next bucket compresses.

A :class:`Wavefront` holds one exchange in progress.  It views the value
and every EF slot per bucket (the slot views by ``slot_strides``, not by
the bucket offset: a chunk-sized slot holds this rank's served elements
only), and walks the (bucket x stage) grid in wavefront order: at tick
``t`` stage ``s`` of position ``t - s`` issues, position ``p`` carrying
bucket ``order[p]``.  Each grid point runs in the executor's two halves
(``plan.executor.issue_op`` / ``complete_op``): issuing stage ``s`` of a
bucket first completes its stage ``s - 1``, issued the tick before, so
within a tick every live stage's collective is launched before the next
one's predecessor is waited on and decompressed.

Backward overlap feeds the buckets one at a time (:meth:`Wavefront.feed`)
and issues stage 0 of every position whose value is there, in ``order``
(:meth:`Wavefront.issue_ready`): a bucket that is ready early waits for
its predecessors in that order, so every rank issues the collectives of
each process group in the same order whatever the timing of its backward
pass.  Such a wavefront is built with ``stage0_first=True``: every stage 0
issues before any later stage, then the later stages run their own
wavefront; the order of the calls then does not depend on how many
stage 0s backward issued.

Numerics are bitwise the serial executor's: buckets are block-aligned,
so per-block compression cannot see their boundaries; the chunk means
reduce the same operands in the same order; every EF slot is consumed
and produced by one op for the elements this rank serves.  Each op's
kernels write in place: the new EF residual into its slice of the new
slot tensor, the last stage's decompress (or mean) into the bucket's
slice of one preallocated ``(d,)`` result (no copies, no whole-vector
concatenation).

The port's counterpart of ``repro/pipeline/executor.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.pipeline.ir import PipelinedPlan
from repro_torch.plan.executor import Errs, Issued, complete_op, issue_op


class Wavefront:
    """One pipelined exchange in progress (see module docstring)."""

    def __init__(self, pplan: PipelinedPlan, comp, errs: Optional[Errs],
                 order: Optional[Sequence[int]] = None,
                 stage0_first: bool = False):
        errs = dict(errs or {})
        missing = [s for s in pplan.err_slots if s not in errs]
        if missing:
            raise KeyError(f"plan {pplan.name!r} needs EF slots {missing}")
        n_b = pplan.n_buckets
        self.pplan, self.comp = pplan, comp
        self.order = tuple(range(n_b)) if order is None else tuple(order)
        if sorted(self.order) != list(range(n_b)):
            raise ValueError(f"order {self.order} is not a permutation of "
                             f"the {n_b} buckets")
        self.stage0_first = stage0_first
        self.strides = pplan.slot_strides()
        self.errs_in = errs
        self.new_errs = {s: torch.empty_like(errs[s]) for s in self.strides}
        self.berrs: List[Errs] = [
            {s: errs[s][self._slot_range(b, s)] for s in self.strides}
            for b in range(n_b)]
        self.vals: List[Optional[torch.Tensor]] = [None] * n_b
        self.pending: Dict[Tuple[int, int], Issued] = {}
        self.issued = set()
        self.out: Optional[torch.Tensor] = None
        self._kind = None       # (dtype, device) of the fed values
        self._next = 0          # positions whose stage 0 issued (a prefix)

    def _slot_range(self, b: int, slot: str) -> slice:
        bp, f = self.pplan.buckets[b], self.strides[slot]
        return slice(bp.offset // f, (bp.offset + bp.size) // f)

    def feed(self, b: int, value: torch.Tensor) -> None:
        """Hand in bucket ``b``'s ``(size,)`` value (issues nothing)."""
        size = self.pplan.buckets[b].size
        if tuple(value.shape) != (size,):
            raise ValueError(f"bucket {b}: value {tuple(value.shape)}, "
                             f"expected ({size},)")
        if (b, 0) in self.issued or self.vals[b] is not None:
            raise RuntimeError(f"bucket {b} was fed twice")
        self.vals[b] = value
        self._kind = (value.dtype, value.device)

    @property
    def stage0_issued(self) -> int:
        """Positions whose stage 0 has issued (a prefix of ``order``)."""
        return self._next

    def fed(self, b: int) -> bool:
        return self.vals[b] is not None or (b, 0) in self.issued

    def issue_ready(self) -> None:
        """Issue stage 0 of the positions, in ``order``, whose values are
        fed, up to the first that is not."""
        while self._next < len(self.order):
            b = self.order[self._next]
            if self.vals[b] is None:
                return
            self._issue(b, 0)
            self._next += 1

    def _issue(self, b: int, s: int) -> None:
        if (b, s - 1) in self.pending:
            self._complete(b, s - 1)
        op = self.pplan.buckets[b].plan.ops[s]
        # the new residual goes straight into its slice of the new slot
        err_out = None if op.err_slot is None else \
            self.new_errs[op.err_slot][self._slot_range(b, op.err_slot)]
        iss = issue_op(op, self.comp, self.vals[b], self.berrs[b], err_out)
        self.vals[b] = None
        self.berrs[b] = iss.errs
        self.pending[(b, s)] = iss
        self.issued.add((b, s))

    def _complete(self, b: int, s: int) -> None:
        iss = self.pending.pop((b, s))
        if s < self.pplan.n_stages - 1:
            self.vals[b], _ = complete_op(iss)
            return
        # the last stage decompresses (or divides) into the bucket's slice
        if self.out is None:        # after backward, when overlapped
            dtype, device = self._kind
            self.out = torch.empty(self.pplan.d, dtype=dtype, device=device)
        bp = self.pplan.buckets[b]
        complete_op(iss, out=self.out[bp.offset:bp.offset + bp.size])

    def schedule(self) -> List[Tuple[int, int]]:
        """Every (bucket, stage) in the order this wavefront issues it."""
        if not self.stage0_first:
            return list(self.pplan.issue_order(self.order))
        n_b, n_s = len(self.order), self.pplan.n_stages
        out = [(b, 0) for b in self.order]
        for tick in range(n_b + n_s - 2):
            for s in range(1, n_s):
                p = tick - (s - 1)
                if 0 <= p < n_b:
                    out.append((self.order[p], s))
        return out

    def finish(self) -> Tuple[torch.Tensor, Errs]:
        """Issue everything not issued yet, complete everything; returns
        (the ``(d,)`` result, the EF slot dict with the new slots)."""
        unfed = [b for b in range(len(self.order)) if not self.fed(b)]
        if unfed:
            raise RuntimeError(f"buckets {unfed} were never fed")
        for b, s in self.schedule():
            if (b, s) not in self.issued:
                self._issue(b, s)
        for b, s in list(self.pending):
            self._complete(b, s)
        errs = dict(self.errs_in)
        errs.update(self.new_errs)
        return self.out, errs


def execute_pipelined(pplan: PipelinedPlan, comp, value,
                      errs: Optional[Errs] = None,
                      order: Optional[Tuple[int, ...]] = None
                      ) -> Tuple[torch.Tensor, Errs]:
    """Run ``pplan`` on this rank's ``value``; returns (result, new errs).

    Same contract as :func:`repro_torch.plan.executor.execute_plan`:
    ``errs`` holds the full-size slots named in ``pplan.err_slots`` (extra
    keys pass through untouched).  ``value`` is the flat ``(d,)`` vector
    (viewed per bucket) or a tuple of per-bucket parts of the bucket
    sizes; in parts mode ``order`` defaults to reversed bucket index,
    the reference's default."""
    parts = value if isinstance(value, (tuple, list)) else None
    if parts is not None:
        if len(parts) != pplan.n_buckets:
            raise ValueError(f"{len(parts)} parts for "
                             f"{pplan.n_buckets} buckets")
        if order is None:
            order = tuple(reversed(range(pplan.n_buckets)))
    elif tuple(value.shape) != (pplan.d,):
        raise ValueError(f"value shape {tuple(value.shape)} != "
                         f"({pplan.d},)")
    wf = Wavefront(pplan, comp, errs, order)
    for b, bp in enumerate(pplan.buckets):
        wf.feed(b, parts[b] if parts is not None
                else value[bp.offset:bp.offset + bp.size])
    return wf.finish()
