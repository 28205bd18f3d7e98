"""The comparison that decides ``correct``.

Two checks, each of three numbers, each number against a limit of its
own (``limits/<cell>.json``, set from the readings ``PERF.md`` gives).

The start: set-up drives the program from the seed through its first
steps (the warmup stage), and the reference follows the first three on
the same weights and rows:

``loss_gap``    the largest relative gap of the three steps' losses;
``grad_gap``    the worst leaf's gap between the norms of the first
                gradient as the optimizer got it (``m / (1 - b1)`` from
                its state after one step) and the reference's, over the
                reference's norm of that leaf or of the median leaf,
                whichever is larger;
``update_gap``  the same for the norm of the parameters' change after the
                three steps, over the leaves whose reference gradient is
                at least a thousandth of the median leaf's.

The switch: where the traffic has a compression stage, the reference
follows every warmup step up to it, and the program's state at the
switch is held against the reference's own:

``switch_momentum_gap``  the worst leaf's gap of the norms of ``m``;
``switch_variance_gap``  the same for ``v``;
``switch_update_gap``    the same for the parameters' change over the
                         warmup, over the moving leaves.

The compression stage: its update divides by a variance that a few
warmup steps leave near zero in places, so a rounding-level difference
in the warmup's gradients moves the compressed update a long way.  The
reference therefore follows the first two compressed steps from the
program's x, m and v at the switch, which the switch numbers vouch for,
and from its own error buffers there (zero: the warmup leaves them):

``comp_loss_gap``      the two steps' losses;
``comp_momentum_gap``  the worst leaf's gap of the norms of the momentum
                       after the first compressed step (the exchanged,
                       compressed average);
``comp_update_gap``    the parameters' change over the two steps, over
                       the leaves whose reference momentum is at least a
                       thousandth of the median leaf's.

Readings are per-leaf sums of squares of one rank's flat vector; a split
leaf's global norm sums its model ranks' shards (dp rank 0's), a
replicated leaf takes model rank 0's copy.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch

START = ("loss_gap", "grad_gap", "update_gap")
SWITCH = ("switch_momentum_gap", "switch_variance_gap", "switch_update_gap")
COMP = ("comp_loss_gap", "comp_momentum_gap", "comp_update_gap")
STEPS = 3          # steps the start check follows
COMP_STEPS = 2     # compressed steps the second check follows
MOVING = 1e-3      # a leaf moves when its reference gradient is above this
                   # share of the median leaf's


def seg_sumsq(vec: torch.Tensor, sizes: Sequence[int],
              start: Optional[torch.Tensor] = None) -> List[float]:
    """Per-leaf sums of squares of a flat vector (the leaves in order, the
    padding tail left out); of ``vec - start`` when ``start`` (any
    device) is given."""
    out, off = [], 0
    for n in sizes:
        seg = vec[off:off + n].float()
        if start is not None:
            seg = seg - start[off:off + n].to(seg.device).float()
        out.append(float(seg.square().sum()))
        off += n
    return out


def leaf_norms(per_rank: List[List[float]], splits: Sequence[bool],
               tp: int) -> List[float]:
    """Global per-leaf norms from every rank's sums of squares (index =
    global rank = dp index * tp + model index)."""
    out = []
    for j, split in enumerate(splits):
        sq = sum(per_rank[m][j] for m in range(tp)) if split else \
            per_rank[0][j]
        out.append(math.sqrt(sq) if sq >= 0 else float("nan"))
    return out


def _gap(a: float, b: float, norm: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b) and math.isfinite(norm)):
        return float("inf")
    return abs(a - b) / norm if norm > 0 else (0.0 if a == b else
                                               float("inf"))


def _worst(prog: List[float], ref: List[float],
           leaves: Optional[List[int]] = None) -> float:
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of that leaf and the median of ``leaves`` (default: all)."""
    js = range(len(ref)) if leaves is None else leaves
    med = statistics.median(ref[j] for j in js)
    return max(_gap(prog[j], ref[j], max(ref[j], med)) for j in js)


def _moving(g_ref: List[float]) -> List[int]:
    g_med = statistics.median(g_ref)
    return [j for j, r in enumerate(g_ref) if r >= MOVING * g_med]


def numbers(prog: dict, ref: dict, names: Sequence[str] = START
            ) -> Dict[str, float]:
    """The three numbers of one check: ``prog`` and ``ref`` hold ``loss``
    (the steps' dp-mean losses), ``g`` (global per-leaf norms of the
    gradient or momentum) and ``dx`` (of the parameters' change)."""
    loss = max(_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))
    return dict(zip(names, (loss, _worst(prog["g"], ref["g"]),
                            _worst(prog["dx"], ref["dx"], _moving(ref["g"])))))


def start_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The start check's numbers, and the switch's where ``prog`` holds
    the state at the switch (``sw_m``, ``sw_v``, ``sw_dx``: global
    per-leaf norms of m, v and the change since the start)."""
    out = numbers(prog, ref, START)
    if "sw_m" in prog:
        out.update(zip(SWITCH, (
            _worst(prog["sw_m"], ref["sw_m"]),
            _worst(prog["sw_v"], ref["sw_v"]),
            _worst(prog["sw_dx"], ref["sw_dx"], _moving(ref["g"])))))
    return out


def verdict(nums: Dict[str, float], limits: dict):
    """(correct, {name: {"value", "limit"}}): every number that has a
    limit is at or under it; a number without one is shown, not
    compared.  No limit at all is never correct."""
    checks, ok = {}, bool(limits)
    for name in nums:
        lim: Optional[float] = (limits.get(name) or {}).get("limit")
        v = nums[name]
        checks[name] = {"value": v, "limit": lim}
        if lim is not None and not (v <= lim):
            ok = False
    return ok, checks
