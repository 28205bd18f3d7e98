"""1-bit Adam (Algorithm 1 of the paper) as a registry optimizer.

The base class *is* 1-bit Adam — frozen variance, EF-compressed momentum
allreduce, preconditioned momentum SGD — so this registration adds no
hooks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.optim.base import TwoStageOptimizer, register_optimizer


@register_optimizer("onebit_adam")
@dataclasses.dataclass(frozen=True)
class OneBitAdam(TwoStageOptimizer):
    name: str = "onebit_adam"
