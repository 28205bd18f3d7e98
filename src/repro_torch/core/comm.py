"""Collectives of the compressed optimizer over ``torch.distributed``: the
paper's ``compressed_allreduce`` lowered through the plan IR.

``axis_names`` plays the role of the reference's mesh axes: a non-empty
tuple (``("dp",)``) is the default process group, ``()`` a single rank
(no collective at all).  The flat schedule is the paper's Figure 3:

  1. worker EF-compress of the local momentum        (Alg. 1 line 7)
  2. ``all_to_all`` of the packed payload chunks     (Fig. 3a)
  3. local average of the received chunks            (Fig. 3b)
  4. server EF-compress of the averaged chunk        (Alg. 1 line 10)
  5. ``all_gather`` of the packed result             (Fig. 3c)

Each rank plays "server" for its own chunk.  The hierarchical two-level
schedule and the bucketed pipeline are later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.plan import executor as _exec
from repro_torch.plan import schedules as _sched

Errs = Dict[str, torch.Tensor]


def axis_size(axis_names: Sequence[str]) -> int:
    """Ranks on the dp axis: the default group's world size, or 1."""
    if not axis_names:
        return 1
    return dist.get_world_size()


def allreduce_mean(x: torch.Tensor, axis_names: Sequence[str]
                   ) -> torch.Tensor:
    """Uncompressed mean of a flat vector over the dp axis (vanilla Adam's
    exchange), lowered through the plan IR."""
    axes = tuple(axis_names)
    if not axes:
        return x
    plan = _sched.allreduce_schedule(x.shape[0], axis_size(axes), axes)
    out, _ = _exec.execute_plan(plan, None, x)
    return out


def compressed_exchange(x: torch.Tensor, errs: Errs,
                        dp_axes: Sequence[str], comp
                        ) -> Tuple[torch.Tensor, Errs]:
    """The compressed optimizer exchange: the flat schedule over
    ``dp_axes`` (the hierarchical one is a later slice).  Takes and
    returns the full EF slot dict (extra keys untouched)."""
    axes = tuple(dp_axes)
    n = axis_size(axes)
    d = x.shape[0]
    if d % n:
        raise ValueError(f"exchange length {d} does not split over {n}")
    plan = _sched.flat_schedule(comp, d, n, axes)
    return _exec.execute_plan(plan, comp, x, errs)


def compressed_allreduce(x: torch.Tensor, worker_err: torch.Tensor,
                         server_err: torch.Tensor,
                         axis_names: Sequence[str], comp
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-compensated compressed allreduce (Alg. 1 lines 7-11).

    x: (D,) local value, D % (n * block) == 0; worker_err: (D,);
    server_err: (D/n,) this rank's server-chunk error.  Returns (averaged
    (D,) identical on every rank, new worker_err, new server_err)."""
    out, errs = compressed_exchange(
        x, {"worker": worker_err, "server": server_err}, axis_names, comp)
    return out, errs["worker"], errs["server"]
