"""Lower a :class:`~repro_torch.plan.ir.CommPlan` to ``torch.distributed``
collectives on per-rank flat f32 vectors.

``execute_plan`` walks the plan op by op, carrying ``value`` (the current
represented f32 vector) and ``errs`` (the error-feedback buffers keyed by
slot name).  An op with ``err_slot`` does an error-compensated
``comp.ef_compress`` (consuming and replacing that slot); ``AllReduce``
moves the raw f32 value.  Before anything crosses the wire the executor
checks that the arrays the compressor hands it match the op's declared
``payload`` WireSpecs.

Each op runs in two halves, so that a pipelined executor can keep one
bucket's collective in flight while it compresses the next:

  * :func:`issue_op` — the compress point, then the collective launched
    with ``async_op=True``;
  * :func:`complete_op` — ``work.wait()``, then the decompress and the
    combine.

:func:`execute_op` (and so the serial ``execute_plan``) calls the two back
to back.  An op runs on the process group its ``axes`` name in the map
:func:`set_groups` holds (``repro_torch.launch.mesh`` builds it from the
mesh); without a map, ``("dp",)`` is the default group.  ``all_to_all``
moves each payload leaf, then one decompress of the n received chunks and
their f32 mean in rank order; ``all_gather`` gathers into one tensor per
leaf, then decompresses; ``all_reduce`` sums, then divides by n.  With
empty ``axes`` the compress/decompress round trip still runs, so
single-rank numerics match the distributed path.

Neither gloo nor NCCL has a 16-bit integer type: a uint16 leaf (the top-k
indices) crosses the wire as its uint8 byte view, the same bytes, and is
viewed back on arrival.  A leaf's byte view chunks exactly as the leaf
does, so the all_to_all and all_gather slicing is unchanged.  Every
tensor handed to an async collective (the sent byte views and the receive
buffers) stays referenced by its :class:`Issued` record until
``complete_op`` has waited on it, and nothing writes to it before then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.obs.trace import count_collective, op_scope, span_name
from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll,
                                 CollectiveOp, CommPlan)

Errs = Dict[str, torch.Tensor]

# axes -> process group (None = the default group); see set_groups
_GROUPS: Dict[Tuple[str, ...], Optional[object]] = {}


def set_groups(groups: Mapping[Tuple[str, ...], Optional[object]]
               ) -> Dict[Tuple[str, ...], Optional[object]]:
    """Install the axes -> ``ProcessGroup`` map every op reads; returns
    the previous map."""
    global _GROUPS
    prev = _GROUPS
    _GROUPS = {tuple(k): v for k, v in groups.items()}
    return prev


def group_of(axes) -> Optional[object]:
    """The process group of mesh ``axes`` (None = the default group)."""
    axes = tuple(axes)
    if axes in _GROUPS:
        return _GROUPS[axes]
    if not _GROUPS and axes == ("dp",):
        return None
    raise KeyError(f"no process group for mesh axes {axes}; the mesh map "
                   f"holds {sorted(_GROUPS)} (repro_torch.launch.mesh"
                   ".build_mesh installs it)")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check_payload(op, payload) -> None:
    got = tuple((_dtype_name(p), tuple(p.shape)) for p in payload)
    want = tuple((w.dtype, w.shape) for w in op.payload)
    if got != want:
        raise RuntimeError(
            f"{op.kind}: compressor payload {got} != plan annotation {want} "
            "— the compressor's wire_specs() and compress() disagree")


def _out_kw(out: Optional[torch.Tensor]) -> dict:
    return {} if out is None else {"out": out}


def _into(out: Optional[torch.Tensor], value: torch.Tensor) -> torch.Tensor:
    return value if out is None else out.copy_(value)


def _compress(op, comp, value: torch.Tensor, errs: Errs,
              err_out: Optional[torch.Tensor] = None
              ) -> Tuple[Tuple[torch.Tensor, ...], Errs]:
    if op.err_slot is not None:
        payload, new_err = comp.ef_compress(value, errs[op.err_slot],
                                            **_out_kw(err_out))
        errs = dict(errs)
        errs[op.err_slot] = new_err
    else:
        payload = comp.compress(value)
    _check_payload(op, payload)
    return payload, errs


def _on_wire(p: torch.Tensor) -> torch.Tensor:
    """The tensor a collective moves for payload leaf ``p``."""
    p = p.contiguous()
    return p.view(torch.uint8) if p.dtype == torch.uint16 else p


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group=None,
                    async_op: bool = False):
    """``out`` = every rank's ``inp`` of ``group`` in rank order."""
    # all_gather_single is the newer name of all_gather_into_tensor
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=async_op)


@dataclasses.dataclass
class Issued:
    """An op between its two halves: the value or payload in flight, the
    receive buffers (one per payload leaf, with the leaf's dtype), the
    collectives' work handles and the EF slots after the compress point."""

    op: CollectiveOp
    comp: object
    errs: Errs
    payload: Tuple[torch.Tensor, ...] = ()
    recv: Tuple[Tuple[torch.Tensor, torch.dtype], ...] = ()
    sent: Tuple[torch.Tensor, ...] = ()
    works: Tuple[object, ...] = ()
    value: Optional[torch.Tensor] = None
    # (plan name, stage, bucket) of the op's trace range
    scope: Tuple[str, int, Optional[int]] = ("plan", 0, None)


# the op kinds issue_op lowers, each inside its op_scope (the profile
# fold parses every one back to its grid cell)
SCOPED_KINDS = ("AllGather", "AllReduce", "AllToAll")


def scoped_op_names(plan: CommPlan) -> Tuple[str, ...]:
    """The range names one serial ``execute_plan`` run opens (tracing
    on), one per op: the expected coverage of a profile fold."""
    return tuple(span_name(plan.name, s, op.kind, op.tier)
                 for s, op in enumerate(plan.ops))


def issue_op(op: CollectiveOp, comp, value: torch.Tensor, errs: Errs,
             err_out: Optional[torch.Tensor] = None,
             plan_name: str = "plan", stage: int = 0,
             bucket: Optional[int] = None) -> Issued:
    """First half of ``op``: its compress point, then its collective
    launched asynchronously (nothing launched with empty ``axes``).
    ``err_out``, when given, receives the op's new EF residual.
    ``plan_name``/``stage``/``bucket`` only name the op's trace range."""
    with op_scope(plan_name, stage, op, bucket):
        iss = _issue(op, comp, value, errs, err_out)
    iss.scope = (plan_name, stage, bucket)
    return iss


def _issue(op: CollectiveOp, comp, value: torch.Tensor, errs: Errs,
           err_out: Optional[torch.Tensor]) -> Issued:
    if isinstance(op, AllReduce):
        if not op.axes:
            return Issued(op, comp, errs, value=value)
        value = value.clone()
        count_collective("all_reduce", value, op.axes, op.n)
        work = dist.all_reduce(value, group=group_of(op.axes),
                               async_op=True)
        return Issued(op, comp, errs, value=value, works=(work,))
    if op.kind not in SCOPED_KINDS:
        raise NotImplementedError(f"the executor lowers {SCOPED_KINDS}, "
                                  f"not {op.kind}")
    payload, errs = _compress(op, comp, value, errs, err_out)
    if not op.axes:
        return Issued(op, comp, errs, payload=payload)
    group = group_of(op.axes)
    recv, sent, works = [], [], []
    for p in payload:
        w = _on_wire(p)
        if isinstance(op, AllToAll):
            r = torch.empty_like(w)
            count_collective("all_to_all_single", w, op.axes, op.n)
            works.append(dist.all_to_all_single(r, w, group=group,
                                                async_op=True))
        else:
            r = torch.empty((op.n * w.shape[0],), dtype=w.dtype,
                            device=w.device)
            count_collective("all_gather_into_tensor", w, op.axes, op.n)
            works.append(all_gather_into(r, w, group=group, async_op=True))
        recv.append((r, p.dtype))
        sent.append(w)
    return Issued(op, comp, errs, recv=tuple(recv), sent=tuple(sent),
                  works=tuple(works))


def complete_op(iss: Issued, out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Errs]:
    """Second half: wait for the collective, then decompress and combine
    (into ``out`` when given), inside a trace range of the same name as
    the first half's.  Returns (value, errs)."""
    plan_name, stage, bucket = iss.scope
    with op_scope(plan_name, stage, iss.op, bucket):
        return _complete(iss, out)


def _complete(iss: Issued, out: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Errs]:
    for w in iss.works:
        w.wait()
    op, comp = iss.op, iss.comp
    if isinstance(op, AllReduce):
        value = iss.value
        if op.axes and op.reduce == "mean":
            return torch.div(value, op.n, out=out), iss.errs
        return _into(out, value), iss.errs
    if not op.axes:
        return comp.decompress(iss.payload, **_out_kw(out)), iss.errs
    payload = tuple(r.view(dt) for r, dt in iss.recv)
    if isinstance(op, AllGather):
        return comp.decompress(payload, **_out_kw(out)), iss.errs
    # chunk j of every leaf came from rank j: the concatenation is itself a
    # valid payload of n * chunk elements (chunks are block-aligned), so
    # one decompress covers all n chunks
    vals = comp.decompress(payload).reshape(op.n, -1)
    acc = vals[0]
    for j in range(1, op.n):        # rank order, as jnp.mean(vals, axis=0)
        acc = acc + vals[j]
    if op.combine == "mean":
        return torch.div(acc, op.n, out=out), iss.errs
    return _into(out, acc), iss.errs


def execute_op(op: CollectiveOp, comp, value: torch.Tensor, errs: Errs,
               plan_name: str = "plan", stage: int = 0
               ) -> Tuple[torch.Tensor, Errs]:
    """Run one op: :func:`issue_op` then :func:`complete_op`."""
    return complete_op(issue_op(op, comp, value, errs, plan_name=plan_name,
                                stage=stage))


def execute_plan(plan: CommPlan, comp, value: torch.Tensor,
                 errs: Optional[Errs] = None) -> Tuple[torch.Tensor, Errs]:
    """Run ``plan`` on this rank's ``value``; returns (result, new errs).
    ``errs`` must hold every key in ``plan.err_slots`` (extra keys pass
    through untouched)."""
    errs = dict(errs or {})
    missing = [s for s in plan.err_slots if s not in errs]
    if missing:
        raise KeyError(f"plan {plan.name!r} needs EF slots {missing}")
    if tuple(value.shape) != (plan.d,):
        raise ValueError(f"value shape {tuple(value.shape)} != ({plan.d},)")
    for stage, op in enumerate(plan.ops):
        value, errs = execute_op(op, comp, value, errs, plan.name, stage)
    return value, errs
