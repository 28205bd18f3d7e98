"""Collectives of the compressed optimizer over ``torch.distributed``: the
paper's ``compressed_allreduce`` lowered through the plan IR.

Axis names play the role of the reference's mesh axes: a non-empty tuple
names the process group the mesh map holds for it
(``repro_torch.launch.mesh``; ``("dp",)`` is the default group when no
mesh was built), ``()`` a single rank (no collective at all).  The flat
schedule is the paper's Figure 3:

  1. worker EF-compress of the local momentum        (Alg. 1 line 7)
  2. ``all_to_all`` of the packed payload chunks     (Fig. 3a)
  3. local average of the received chunks            (Fig. 3b)
  4. server EF-compress of the averaged chunk        (Alg. 1 line 10)
  5. ``all_gather`` of the packed result             (Fig. 3c)

Each rank plays "server" for its own chunk.  With ``pod_axes`` the
exchange runs the hierarchical two-level schedule instead: steps 1-3
within the pod, the averaged server chunk re-reduced across pods
(compressed legs, or a plain all-reduce for a lossless compressor), then
steps 4-5 within the pod.  ``n_buckets > 1`` runs either schedule through
the bucketed pipelined executor (``repro_torch.pipeline``), bitwise the
serial one.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.plan import executor as _exec
from repro_torch.plan import schedules as _sched

AxisNames = Tuple[str, ...]
Errs = Dict[str, torch.Tensor]


def axis_size(axis_names: Sequence[str]) -> int:
    """Ranks on the mesh axes: their process group's size, or 1."""
    if not axis_names:
        return 1
    return dist.get_world_size(_exec.group_of(axis_names))


def axis_index(axis_names: Sequence[str]) -> int:
    """This rank's index on the mesh axes (0 without axes)."""
    if not axis_names:
        return 0
    return dist.get_rank(_exec.group_of(axis_names))


def allreduce_mean(x: torch.Tensor, axis_names: Sequence[str]
                   ) -> torch.Tensor:
    """Uncompressed mean of a flat vector over the axes (vanilla Adam's
    exchange), lowered through the plan IR."""
    axes = tuple(axis_names)
    if not axes:
        return x
    plan = _sched.allreduce_schedule(x.shape[0], axis_size(axes), axes)
    out, _ = _exec.execute_plan(plan, None, x)
    return out


def flat_dim(x) -> int:
    """Element count of an exchange value: a ``(d,)`` vector or a tuple of
    per-bucket parts adding up to ``d``."""
    if isinstance(x, (tuple, list)):
        return int(sum(p.shape[0] for p in x))
    return int(x.shape[0])


def exchange_plan(d: int, errs: Errs, dp_axes: Sequence[str],
                  pod_axes: Sequence[str], comp):
    """(plan, n_total): the flat schedule over ``dp_axes`` when
    ``pod_axes`` is empty, else the hierarchical one (``dp_axes`` within
    the pod, ``pod_axes`` across pods)."""
    axes_in, axes_out = tuple(dp_axes), tuple(pod_axes)
    n_in = axis_size(axes_in)
    if not axes_out:
        return _sched.flat_schedule(comp, d, n_in, axes_in), n_in
    outer_ef = _sched.needs_outer_ef(comp)
    if outer_ef and not ("outer" in errs and "outer_ag" in errs):
        raise ValueError(
            "the hierarchical topology needs a dense (or lossless) "
            "compressor, or the outer/outer_ag EF slots: un-compensated "
            "cross-pod legs would drop the sparse residual of "
            f"{type(comp).__name__} for good")
    n_out = axis_size(axes_out)
    plan = _sched.hier_schedule(comp, d, n_in, n_out, axes_in, axes_out,
                                outer_ef=outer_ef)
    return plan, n_in * n_out


def _pipelined_plan(plan, comp, n_buckets: int, n_total: int):
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    # bucket alignment to the compressor's blocks is what makes per-bucket
    # compression bitwise the serial schedule
    bucketer = Bucketer.for_exchange(plan.d, n_total, comp.block_size,
                                     n_buckets)
    return lower_to_pipelined(plan, comp, bucketer)


def _execute(plan, comp, value, errs, n_buckets: int, n_total: int):
    """Lower ``plan`` serially, or, for ``n_buckets > 1``, through the
    pipelined executor (the bucket count clamps to the alignment units).
    A tuple of parts must match the buckets (one part of ``d`` serially)."""
    parts = value if isinstance(value, (tuple, list)) else None
    pplan = None
    if n_buckets > 1:
        pplan = _pipelined_plan(plan, comp, n_buckets, n_total)
    if parts is not None:
        want = (plan.d,) if pplan is None else \
            tuple(bp.size for bp in pplan.buckets)
        got = tuple(p.shape[0] for p in parts)
        if got != want:
            raise ValueError(f"exchange parts of {got} elements do not "
                             f"match the buckets {want}")
        if pplan is None:
            value = parts[0]
    if pplan is None:
        return _exec.execute_plan(plan, comp, value, errs)
    from repro_torch.pipeline import execute_pipelined
    return execute_pipelined(pplan, comp, value, errs)


def compressed_exchange(x, errs: Errs, dp_axes: Sequence[str],
                        pod_axes: Sequence[str], comp, n_buckets: int = 1
                        ) -> Tuple[torch.Tensor, Errs]:
    """The compressed optimizer exchange: the flat schedule over
    ``dp_axes`` when ``pod_axes`` is empty, the hierarchical one
    otherwise.  ``x`` is the ``(d,)`` value or a tuple of per-bucket parts
    in element order; the result is one ``(d,)`` vector.  Takes and
    returns the full EF slot dict (extra keys untouched)."""
    plan, n_total = exchange_plan(flat_dim(x), errs, dp_axes, pod_axes,
                                  comp)
    return _execute(plan, comp, x, errs, n_buckets, n_total)


def start_exchange(d: int, errs: Errs, dp_axes: Sequence[str],
                   pod_axes: Sequence[str], comp, n_buckets: int,
                   order_of=None):
    """The pipelined exchange of a ``d``-vector as a
    :class:`~repro_torch.pipeline.Wavefront` that its caller feeds bucket
    by bucket (backward overlap), every stage 0 first.  ``order_of`` maps
    the plan's buckets to their issue order (default: reversed bucket
    index, the reference's).  None when the bucket count clamps to 1."""
    from repro_torch.pipeline import Wavefront
    plan, n_total = exchange_plan(d, errs, dp_axes, pod_axes, comp)
    pplan = _pipelined_plan(plan, comp, n_buckets, n_total)
    if pplan.n_buckets <= 1:
        return None
    order = tuple(reversed(range(pplan.n_buckets))) if order_of is None \
        else tuple(order_of(pplan.buckets))
    return Wavefront(pplan, comp, errs, order=order, stage0_first=True)


def compressed_allreduce(x: torch.Tensor, worker_err: torch.Tensor,
                         server_err: torch.Tensor,
                         axis_names: Sequence[str], comp,
                         n_buckets: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-compensated compressed allreduce (Alg. 1 lines 7-11).

    x: (D,) local value, D % (n * block) == 0; worker_err: (D,);
    server_err: (D/n,) this rank's server-chunk error.  Returns (averaged
    (D,) identical on every rank, new worker_err, new server_err)."""
    out, errs = compressed_exchange(
        x, {"worker": worker_err, "server": server_err}, axis_names, (),
        comp, n_buckets=n_buckets)
    return out, errs["worker"], errs["server"]


def compressed_allreduce_hierarchical(x, errs: Errs,
                                      inner_axes: Sequence[str],
                                      outer_axes: Sequence[str], comp,
                                      n_buckets: int = 1
                                      ) -> Tuple[torch.Tensor, Errs]:
    """The two-level exchange: worker compress, all_to_all and mean over
    the intra-pod ``inner_axes``, the server chunk re-reduced across pods
    over ``outer_axes``, then server compress and all_gather within the
    pod.  ``errs`` holds ``worker`` (D,) and ``server`` (D/n_inner,), and
    for a sparse compressor ``outer`` and ``outer_ag`` too (extra keys
    pass through).  Returns ``(out, new_errs)``: the reference's
    signature, over :func:`compressed_exchange`."""
    return compressed_exchange(x, errs, inner_axes, outer_axes, comp,
                               n_buckets=n_buckets)
