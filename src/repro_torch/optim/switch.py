"""WarmupSwitch — the warmup -> compression stage policy, on the host.

  * ``steps`` — manual T_w: switch at a fixed step count (the paper's main
    experiments);
  * ``auto``  — the Sec. 7.1 rule
    (:class:`repro_torch.core.variance.VarianceMonitor`).

The driver calls ``observe(step, stats)`` after every step and
``compressed(step)`` before the next one.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from repro_torch.core.variance import VarianceMonitor

MODES = ("steps", "auto")


class WarmupSwitch:
    def __init__(self, mode: str = "steps", warmup_steps: int = 100,
                 b2: float = 0.999, threshold: float = 0.96,
                 lr_warmup_steps: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown switch mode {mode!r}")
        self.mode = mode
        self.warmup_steps = warmup_steps
        self.monitor = VarianceMonitor(b2=b2, threshold=threshold,
                                       lr_warmup_steps=lr_warmup_steps)
        self._frozen_at: Optional[int] = None
        if mode == "steps" and warmup_steps == 0:
            self._frozen_at = 0

    def observe(self, step: int, stats: Dict[str, float],
                on_warning: Optional[Callable[[int, str], None]] = None
                ) -> bool:
        """Feed one step's metrics; returns True once frozen."""
        if self.mode == "auto":
            v = float(stats["v_l1"])
            if not math.isfinite(v) and on_warning is not None:
                on_warning(step, f"non-finite v_l1 ({v!r}) rejected by "
                                 "the variance monitor")
            if self._frozen_at is None and self.monitor.observe(step, v):
                self._frozen_at = step + 1
        elif self._frozen_at is None and step + 1 >= self.warmup_steps:
            self._frozen_at = self.warmup_steps
        return self._frozen_at is not None

    def compressed(self, step: int) -> bool:
        """True when step ``step`` should run the compression stage."""
        if self.mode == "steps":
            return step >= self.warmup_steps
        return self._frozen_at is not None and step >= self._frozen_at

    @property
    def switch_step(self) -> Optional[int]:
        return self._frozen_at

    @property
    def ratio(self):
        return self.monitor.ratio
