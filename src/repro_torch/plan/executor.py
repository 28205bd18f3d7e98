"""Lower a :class:`~repro_torch.plan.ir.CommPlan` to ``torch.distributed``
collectives on per-rank flat f32 vectors.

``execute_plan`` walks the plan op by op, carrying ``value`` (the current
represented f32 vector) and ``errs`` (the error-feedback buffers keyed by
slot name).  An op with ``err_slot`` does an error-compensated
``comp.ef_compress`` (consuming and replacing that slot); ``AllReduce``
moves the raw f32 value.  Before anything crosses the wire the executor
checks that the arrays the compressor hands it match the op's declared
``payload`` WireSpecs.

An op whose ``axes`` is non-empty runs over the default process group:
``all_to_all_single`` per payload leaf, then one decompress of the n
received chunks and their f32 mean in rank order; ``all_gather`` into one
tensor per leaf, then decompress; ``all_reduce`` (sum, then the division
by n).  With empty ``axes`` the compress/decompress round trip still runs,
so single-rank numerics match the distributed path.

Neither gloo nor NCCL has a 16-bit integer type: a uint16 leaf (the top-k
indices) crosses the wire as its uint8 byte view, the same bytes, and is
viewed back on arrival.  A leaf's byte view chunks exactly as the leaf
does, so the all_to_all and all_gather slicing is unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.plan.ir import AllGather, AllReduce, AllToAll, CommPlan

Errs = Dict[str, torch.Tensor]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check_payload(op, payload) -> None:
    got = tuple((_dtype_name(p), tuple(p.shape)) for p in payload)
    want = tuple((w.dtype, w.shape) for w in op.payload)
    if got != want:
        raise RuntimeError(
            f"{op.kind}: compressor payload {got} != plan annotation {want} "
            "— the compressor's wire_specs() and compress() disagree")


def _compress(op, comp, value: torch.Tensor, errs: Errs
              ) -> Tuple[Tuple[torch.Tensor, ...], Errs]:
    if op.err_slot is not None:
        payload, new_err = comp.ef_compress(value, errs[op.err_slot])
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


def _all_gather_into(out: torch.Tensor, inp: torch.Tensor) -> None:
    # all_gather_single is the newer name of all_gather_into_tensor
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp)


def _exec_all_to_all(op: AllToAll, comp, value, errs):
    payload, errs = _compress(op, comp, value, errs)
    if not op.axes:
        return comp.decompress(payload), errs
    recv = []
    for p in payload:
        w = _on_wire(p)
        r = torch.empty_like(w)
        dist.all_to_all_single(r, w)
        recv.append(r.view(p.dtype))
    # chunk j of every leaf came from rank j: the concatenation is itself a
    # valid payload of n * chunk elements (chunks are block-aligned), so
    # one decompress covers all n chunks
    vals = comp.decompress(tuple(recv)).reshape(op.n, -1)
    acc = vals[0]
    for j in range(1, op.n):        # rank order, as jnp.mean(vals, axis=0)
        acc = acc + vals[j]
    value = acc / op.n if op.combine == "mean" else acc
    return value, errs


def _exec_all_gather(op: AllGather, comp, value, errs):
    payload, errs = _compress(op, comp, value, errs)
    if op.axes:
        out = []
        for p in payload:
            w = _on_wire(p)
            o = torch.empty((op.n * w.shape[0],), dtype=w.dtype,
                            device=w.device)
            _all_gather_into(o, w)
            out.append(o.view(p.dtype))
        payload = tuple(out)
    return comp.decompress(payload), errs


def _exec_all_reduce(op: AllReduce, comp, value, errs):
    if op.axes:
        value = value.clone()
        dist.all_reduce(value)
        if op.reduce == "mean":
            value = value / op.n
    return value, errs


_EXEC = {
    AllToAll: _exec_all_to_all,
    AllGather: _exec_all_gather,
    AllReduce: _exec_all_reduce,
}


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
    for op in plan.ops:
        value, errs = _EXEC[type(op)](op, comp, value, errs)
    return value, errs
