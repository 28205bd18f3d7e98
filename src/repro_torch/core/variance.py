"""Variance-stability monitor — the paper's auto-warmup rule (Sec. 7.1).

Freeze the Adam variance (end the warmup stage) at the first step t where
LR warmup has finished and ||v_t||_1 / ||v_{t-Delta}||_1 >= threshold,
with Delta = 1/(1-b2).  Runs on the host on the scalar ``v_l1`` stat of
the warmup step.
"""
from __future__ import annotations

import math
from typing import Optional


class VarianceMonitor:
    def __init__(self, b2: float = 0.999, threshold: float = 0.96,
                 lr_warmup_steps: int = 0):
        self.delta = max(int(round(1.0 / (1.0 - b2))), 1)
        self.threshold = threshold
        self.lr_warmup_steps = lr_warmup_steps
        self.history: list[float] = []
        self.freeze_step: Optional[int] = None
        self.n_rejected = 0

    def observe(self, step: int, v_l1: float) -> bool:
        """Record ||v_t||_1; returns True when the warmup should end.
        Non-finite values are rejected (and counted), never recorded: a NaN
        in the Delta-window would block the rule for ``delta`` steps."""
        v = float(v_l1)
        if not math.isfinite(v):
            self.n_rejected += 1
            return self.freeze_step is not None
        self.history.append(v)
        if self.freeze_step is not None:
            return True
        if step < self.lr_warmup_steps or len(self.history) <= self.delta:
            return False
        prev = self.history[-1 - self.delta]
        if prev > 0 and self.history[-1] / prev >= self.threshold:
            self.freeze_step = step
            return True
        return False

    @property
    def ratio(self) -> Optional[float]:
        if len(self.history) <= self.delta:
            return None
        prev = self.history[-1 - self.delta]
        return self.history[-1] / prev if prev > 0 else None
