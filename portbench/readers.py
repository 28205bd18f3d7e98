"""Shared arithmetic of the metric readers (``metrics/<name>.py``).

A reader's ``read(run)`` returns its metric's value, or None where the
run holds nothing for it to read.  ``run`` carries the window's facts
(``window_s``, ``window_steps``, ``tokens_per_step``, ``step_flops``,
``setup_s``, ``peak_bytes``, ``chips``, ``peaks``) and, in a traced run,
``traced``: one fold of ``tracefold`` a rank.
"""
from __future__ import annotations

from typing import Callable, Optional


def kernel_ms(run: dict, keep: Callable[[dict], bool]) -> Optional[float]:
    """Device ms a traced step of the kernels ``keep`` accepts, on the
    rank where they take longest."""
    traced = run.get("traced")
    if not traced:
        return None
    per_rank = [sum(k["s"] for k in t["kernels"] if keep(k)) / t["steps"]
                for t in traced if t["steps"]]
    if not per_rank or not any(per_rank):
        return None
    return max(per_rank) * 1e3


def roofline(run: dict, metric: str, cost: Callable[..., tuple]
             ) -> Optional[float]:
    """Percent of the bound: the least time the data sheet allows each
    launch (its bytes over the HBM rate or its operations over the float32
    rate, whichever is larger), summed over every rank's launches, over
    their device time."""
    traced = run.get("traced")
    if not traced:
        return None
    peaks = run["peaks"]
    bound = device = 0.0
    for t in traced:
        for size, seconds in t["launches"].get(metric) or ():
            flops, nbytes = cost(**size)
            bound += max(nbytes / peaks["hbm_bytes_per_s"],
                         flops / peaks["f32_flops"])
            device += seconds
    return 100.0 * bound / device if device > 0 else None
