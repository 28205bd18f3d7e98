"""0/1 Adam (arXiv:2202.06009) — adaptive variance freezing + 0-bit steps.

Generalises 1-bit Adam along both of its frozen dimensions:

  * **adaptive variance state freezing** — the second moment keeps
    updating during the compression stage on an interval schedule (the
    first SYNC step once ``var_update_interval`` steps have passed since
    the last update, tracked in ``v_step``) until ``var_freeze_step``.
    When every step syncs, ``g_hat = (m_bar - b1 * m_prev) / (1 - b1)``
    recovers the EF-averaged dp-mean gradient; when the sync schedule can
    skip, ``m_prev`` is per-rank between syncs, so the estimate is the
    synchronised momentum ``m_bar`` itself (dp-consistent);
  * **adaptive local steps ("0-bit" sync skipping)** — ``sync_due(step)``
    is the paper's growing local-step schedule: the interval between
    synchronisations doubles every ``sync_double_every`` steps, capped at
    ``sync_max_interval``.  A skipped step moves no bytes (see
    ``TwoStageOptimizer.update``) and needs the "local" state layout.

With ``var_update_interval = 0`` and ``sync_double_every = 0`` this is
exactly 1-bit Adam.  The port's copy of ``repro/optim/zerone_adam.py``,
audit hook included (``v_live`` of ``repro_torch.obs.audit``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.base import TwoStageOptimizer, register_optimizer


@register_optimizer("zerone_adam")
@dataclasses.dataclass(frozen=True)
class ZeroneAdam(TwoStageOptimizer):
    # variance policy: update v every k-th compression-stage step while
    # count <= var_freeze_step (0 = fully frozen, as 1-bit Adam)
    var_update_interval: int = 16
    var_freeze_step: int = 1_000
    # sync policy: interval doubles every `sync_double_every` steps
    # (0 = sync every step), capped at sync_max_interval
    sync_base_interval: int = 1
    sync_double_every: int = 0
    sync_max_interval: int = 16

    name: str = "zerone_adam"

    def _update_v(self, v, v_step, m_prev, m_bar, count):
        if self.var_update_interval <= 0:
            return v, v_step
        if self.may_skip_sync:
            # m_prev diverges per dp rank between syncs; m_bar is the
            # dp-consistent (synced) estimate
            g_hat = m_bar
        else:
            g_hat = (m_bar - self.b1 * m_prev) / (1.0 - self.b1)
        # fire on the first sync step once the interval has elapsed
        due = (count - v_step >= self.var_update_interval) & \
            (count <= self.var_freeze_step)
        v_new = self.b2 * v + (1.0 - self.b2) * torch.square(g_hat)
        return torch.where(due, v_new, v), torch.where(due, count, v_step)

    def _audit_v_live(self, state):
        # v keeps refreshing on the interval schedule until
        # var_freeze_step: shadow-vs-live drift is EXPECTED there, and the
        # HealthMonitor must not call it a violated assumption
        if self.var_update_interval <= 0:
            return super()._audit_v_live(state)
        return (state.count <= self.var_freeze_step).to(torch.float32)

    def sync_due(self, step: int) -> bool:
        if self.sync_double_every <= 0:
            return True
        interval = min(
            self.sync_base_interval << (step // self.sync_double_every),
            self.sync_max_interval)
        return step % max(interval, 1) == 0

    @property
    def may_skip_sync(self) -> bool:
        return self.sync_double_every > 0
