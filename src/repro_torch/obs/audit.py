"""Per-segment compression-fidelity & frozen-variance health audit.

1-bit Adam's correctness rests on one empirical claim: Adam's second
moment stabilises after warmup and can be frozen as a fixed
preconditioner (paper Sec. 7.1, Fig. 2).  The training loop checks it
once, at the stage switch, through the whole-model ``v_l1`` ratio; this
module makes the training signal observable per layer group for the
rest of the run.  The port of ``repro/obs/audit.py``:

  * :func:`make_audit_probe` — a plain function (the port has no jit)
    that re-runs forward and backward on the step's own batch into ITS
    OWN gradient buffer (never ``TrainState.g``), then calls
    :meth:`TwoStageOptimizer.audit_stats`, which reads the state and
    hands the compressor fresh buffers: ``--audit on`` leaves training
    bitwise unchanged.

      - **frozen-variance validity**: a shadow variance EMA advanced on
        the dp-mean gradient every audited step, compared per segment
        against the frozen ``v`` (L1 ratio; Fig. 2 at layer grain);
      - **compression fidelity**: per-segment cosine similarity and sign
        agreement of the EF-compensated momentum vs its decompressed
        wire image, plus per-segment worker/server EF-residual mass.

    Stats stay on the device and are fetched through the batched
    :class:`repro_torch.obs.metrics.MetricBuffer` path.

  * :class:`HealthMonitor` — host-side: folds each audited step's
    fidelity stats plus the trailing loss window into a ``health``
    verdict event (``variance_drift``, ``ef_blowup``, ``non_finite``,
    ``loss_spike``; memory samples add ``mem_headroom`` and
    ``mem_growth``).

  * :class:`FiniteGuard` — drops non-finite optimizer stats from the step
    record, counts them, and hands them to a ``warning`` callback.

Wired as ``repro_torch.launch.train --audit {off,on} --audit-every N``.
"""
from __future__ import annotations

import math
import statistics
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

AUDIT_MODES = ("off", "on")

# HealthMonitor defaults: the variance-drift acceptance band (the
# shadow/frozen per-segment L1 ratio must stay within [1/band, band]),
# the per-audit EF-residual growth ceiling, and the loss-spike factor
# over the trailing median
DRIFT_BAND = 2.0
ERR_GROWTH_MAX = 10.0

# memory-verdict defaults (HealthMonitor.observe_memory): the fraction
# of capacity the sampled peak may reach before ``mem_headroom`` fires,
# how many consecutive log windows of strictly-rising bytes_in_use make
# a ``mem_growth`` (leak) verdict, and the minimum total rise over that
# run (allocator jitter is not a leak)
MEM_HEADROOM_FRAC = 0.92
MEM_GROWTH_WINDOWS = 4
MEM_GROWTH_MIN_FRAC = 0.05
LOSS_SPIKE_FACTOR = 3.0


def make_audit_probe(ts, optimizer, dp_axes=(), pod_axes=(), tp_axes=()):
    """The per-segment audit probe of one training setup.

    ``ts`` is the run's :class:`~repro_torch.train.step.TrainState`,
    ``optimizer`` its optimizer, ``dp_axes`` / ``pod_axes`` the exchange's
    axes as ``train_step`` splits them (within the pod / across pods),
    ``tp_axes`` the model axis (its ranks' shards summed into the
    per-segment stats).
    Returns ``probe(batch, shadow_v) -> (new_shadow_v, stats)``: the
    gradient of ``batch`` at the current parameters into the probe's own
    buffer (the model's ``.grad`` views point at it for the backward and
    back at ``ts.g`` after it), then ``optimizer.audit_stats``.  Nothing
    of ``ts`` is written.  The only state the probe carries forward is
    the shadow variance EMA (seed it with a copy of the live ``v`` at the
    first audited step).  ``probe.stat_keys`` names the stats.

    Raises under zero1, which shards ``v``.
    """
    import torch

    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim.base import AUDIT_SCALAR_KEYS, AUDIT_SEG_KEYS

    if ts.layout not in ("replicated", "local") or "v" not in ts.opt:
        raise ValueError(f"the audit probe needs the full 'v' slot; "
                         f"layout {ts.layout!r} shards it")
    g = torch.zeros_like(ts.g)

    def probe(batch, shadow_v):
        g.zero_()
        ts.model.bind_grads(g)
        try:
            tot, _ = loss_fn(ts.model, batch)
            tot.backward()
        finally:
            ts.model.bind_grads(ts.g)
        with torch.no_grad():
            return optimizer.audit_stats(g, ts.opt, shadow_v,
                                         dp_axes=dp_axes, pod_axes=pod_axes,
                                         segs=ts.segs, tp_axes=tp_axes)

    probe.stat_keys = tuple(AUDIT_SEG_KEYS) + tuple(AUDIT_SCALAR_KEYS) \
        + tuple(optimizer.audit_extra_keys)
    probe.optimizer = optimizer
    return probe


# --------------------------------------------------------------------------
# host-side folding
# --------------------------------------------------------------------------

def _finite(v) -> bool:
    vals = v if isinstance(v, list) else [v]
    return all(isinstance(x, (int, float)) and not isinstance(x, bool)
               and math.isfinite(x) for x in vals)


class HealthMonitor:
    """Fold audited fidelity stats + the per-step loss stream into
    ``health`` verdicts.

    Feed every drained step's loss through :meth:`observe_loss`; feed
    each audited step's host fidelity dict through :meth:`observe`,
    which returns ``(health_event_fields, warning_event_fields_list)``.
    Verdicts (:data:`repro_torch.obs.events.HEALTH_VERDICTS`):

      * ``non_finite``     — any fidelity stat is NaN/inf;
      * ``variance_drift`` — a per-segment shadow/frozen L1 ratio left
        ``[1/drift_band, drift_band]`` while the family reports the
        variance as frozen (``v_live`` = 0; 0/1 Adam's live-refresh
        phase is exempt);
      * ``ef_blowup``      — worker/server EF-residual norm grew more
        than ``err_growth_max`` x since the previous audit;
      * ``loss_spike``     — the latest loss exceeds ``loss_spike`` x
        the trailing-window median.

    Live memory samples (``launch.train --memory on``,
    :mod:`repro_torch.obs.mem`) feed :meth:`observe_memory`, which adds
    two more verdicts:

      * ``mem_headroom``   — the sampled peak reaches
        ``mem_headroom_frac`` of device capacity (imminent OOM);
      * ``mem_growth``     — ``bytes_in_use`` rose STRICTLY across the
        last ``mem_growth_windows`` log windows by more than
        ``mem_growth_min_frac`` total — leak detection (a healthy run
        plateaus after the first steady-state window).
    """

    def __init__(self, drift_band: float = DRIFT_BAND,
                 err_growth_max: float = ERR_GROWTH_MAX,
                 loss_spike: float = LOSS_SPIKE_FACTOR,
                 loss_window: int = 16,
                 mem_headroom_frac: float = MEM_HEADROOM_FRAC,
                 mem_growth_windows: int = MEM_GROWTH_WINDOWS,
                 mem_growth_min_frac: float = MEM_GROWTH_MIN_FRAC):
        assert drift_band > 1.0, drift_band
        self.drift_band = float(drift_band)
        self.err_growth_max = float(err_growth_max)
        self.loss_spike = float(loss_spike)
        self._losses: deque = deque(maxlen=max(int(loss_window), 4))
        self._last_loss: Optional[Tuple[int, float]] = None
        self._prev_err: Optional[Tuple[float, float]] = None
        self.n_checked = 0
        self.n_failed = 0
        assert 0.0 < mem_headroom_frac <= 1.0, mem_headroom_frac
        self.mem_headroom_frac = float(mem_headroom_frac)
        self.mem_growth_min_frac = float(mem_growth_min_frac)
        self._mem_samples: deque = deque(
            maxlen=max(int(mem_growth_windows), 2) + 1)
        self.n_mem_checked = 0
        self.n_mem_failed = 0

    def observe_loss(self, step: int, loss) -> None:
        """Record one step's loss (non-finite values are ignored — the
        FiniteGuard/warning path owns those)."""
        if isinstance(loss, (int, float)) and math.isfinite(loss):
            self._losses.append(float(loss))
            self._last_loss = (int(step), float(loss))

    def observe(self, step: int, fid: Dict[str, object]
                ) -> Tuple[dict, List[dict]]:
        """One audited step's host fidelity stats -> the ``health``
        event fields plus one ``warning`` event's fields per verdict."""
        verdicts: List[str] = []
        details: List[str] = []

        bad = sorted(k for k, v in fid.items()
                     if isinstance(v, (int, float, list))
                     and not isinstance(v, bool) and not _finite(v))
        if bad:
            verdicts.append("non_finite")
            details.append("non-finite stats: " + ", ".join(bad))

        drift = fid.get("v_drift")
        drift = drift if isinstance(drift, list) else []
        finite_drift = [x for x in drift if math.isfinite(x)]
        v_drift_max = max(finite_drift) if finite_drift else None
        live = isinstance(fid.get("v_live"), (int, float)) \
            and fid["v_live"] >= 0.5
        if finite_drift and not live:
            lo, hi = 1.0 / self.drift_band, self.drift_band
            out = [i for i, x in enumerate(drift)
                   if math.isfinite(x) and not lo <= x <= hi]
            if out:
                verdicts.append("variance_drift")
                worst = sorted(
                    out, reverse=True,
                    key=lambda i: abs(math.log(max(drift[i], 1e-30))))
                details.append(
                    f"frozen-v drift outside [{lo:.3g}, {hi:.3g}] in "
                    f"{len(out)} segment(s); worst " + " ".join(
                        f"{i}:{drift[i]:.3g}" for i in worst[:3]))

        err_growth = None
        wn, sn = fid.get("worker_err_norm"), fid.get("server_err_norm")
        if self._prev_err is not None:
            ratios = [c / p for c, p in zip((wn, sn), self._prev_err)
                      if isinstance(c, (int, float)) and math.isfinite(c)
                      and p and p > 0.0]
            if ratios:
                err_growth = max(ratios)
                if err_growth > self.err_growth_max:
                    verdicts.append("ef_blowup")
                    details.append(
                        f"EF residual grew {err_growth:.3g}x since the "
                        f"last audit (> {self.err_growth_max:g}x)")
        if isinstance(wn, (int, float)) and math.isfinite(wn):
            self._prev_err = (float(wn),
                              float(sn) if isinstance(sn, (int, float))
                              and math.isfinite(sn) else 0.0)

        loss = loss_median = None
        if self._last_loss is not None and len(self._losses) >= 4:
            loss = self._last_loss[1]
            trailing = list(self._losses)[:-1]   # median EXCLUDES the
            loss_median = statistics.median(trailing)  # loss it judges
            if loss_median > 0.0 and loss > self.loss_spike * loss_median:
                verdicts.append("loss_spike")
                details.append(
                    f"loss {loss:.4g} > {self.loss_spike:g}x trailing "
                    f"median {loss_median:.4g}")

        ok = not verdicts
        self.n_checked += 1
        self.n_failed += 0 if ok else 1
        fields: Dict[str, object] = {
            "step": int(step), "ok": ok, "verdicts": verdicts,
            "source": "repro_torch.obs.audit"}
        for k, v in (("v_ratio", fid.get("v_ratio")),
                     ("v_drift_max", v_drift_max),
                     ("err_growth", err_growth),
                     ("loss", loss), ("loss_median", loss_median)):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                fields[k] = float(v)
        if details:
            fields["detail"] = "; ".join(details)
        warns = [{"what": f"audit.{v}", "step": int(step),
                  "detail": "; ".join(details)} for v in verdicts]
        return fields, warns

    def observe_memory(self, step: int, bytes_in_use: float,
                       peak_bytes_in_use: Optional[float] = None,
                       capacity_bytes: Optional[float] = None
                       ) -> Tuple[dict, List[dict]]:
        """One log window's live memory sample (repro_torch.obs.mem) -> the
        ``health`` event fields + one ``warning``'s fields per verdict
        (``mem_headroom`` / ``mem_growth``)."""
        verdicts: List[str] = []
        details: List[str] = []
        in_use = float(bytes_in_use)
        peak = (float(peak_bytes_in_use)
                if isinstance(peak_bytes_in_use, (int, float))
                and math.isfinite(peak_bytes_in_use) else in_use)

        headroom = None
        if capacity_bytes and capacity_bytes > 0:
            headroom = peak / float(capacity_bytes)
            if headroom >= self.mem_headroom_frac:
                verdicts.append("mem_headroom")
                details.append(
                    f"peak {peak / 2 ** 30:.2f} GiB is {headroom:.1%} of "
                    f"{capacity_bytes / 2 ** 30:.2f} GiB capacity "
                    f"(>= {self.mem_headroom_frac:.0%})")

        self._mem_samples.append(in_use)
        growth = None
        if len(self._mem_samples) == self._mem_samples.maxlen:
            xs = list(self._mem_samples)
            rising = all(b > a for a, b in zip(xs, xs[1:]))
            if rising and xs[0] > 0:
                growth = xs[-1] / xs[0] - 1.0
                if growth > self.mem_growth_min_frac:
                    verdicts.append("mem_growth")
                    details.append(
                        f"bytes_in_use rose {growth:+.1%} over the last "
                        f"{len(xs) - 1} window(s) with no plateau — "
                        "possible leak")

        ok = not verdicts
        self.n_mem_checked += 1
        self.n_mem_failed += 0 if ok else 1
        fields: Dict[str, object] = {
            "step": int(step), "ok": ok, "verdicts": verdicts,
            "bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "source": "repro_torch.obs.mem"}
        if capacity_bytes:
            fields["capacity_bytes"] = float(capacity_bytes)
        if headroom is not None:
            fields["headroom_frac"] = float(headroom)
        if growth is not None:
            fields["growth_frac"] = float(growth)
        if details:
            fields["detail"] = "; ".join(details)
        warns = [{"what": f"memory.{v}", "step": int(step),
                  "detail": "; ".join(details)} for v in verdicts]
        return fields, warns


class FiniteGuard:
    """Reject non-finite optimizer stats from host step records.

    The auto-switch already rejects a non-finite ``v_l1``
    (:class:`repro_torch.core.variance.VarianceMonitor`); every other
    :data:`repro_torch.optim.base.STAT_KEYS` entry is checked here.
    :meth:`filter` returns the record with offending keys DROPPED (an
    absent metric is honest; a recorded NaN poisons every downstream
    fold), counts rejections per key, and calls ``on_reject(step, key,
    value)`` so the driver can emit the ``warning`` event."""

    def __init__(self, keys: Optional[Tuple[str, ...]] = None):
        if keys is None:
            from repro_torch.optim.base import STAT_KEYS
            keys = STAT_KEYS
        self.keys = tuple(keys)
        self.n_rejected = 0
        self.rejected: Dict[str, int] = {}

    def filter(self, step: int, rec: Dict[str, object],
               on_reject: Optional[Callable[[int, str, float], None]]
               = None) -> Dict[str, object]:
        clean = dict(rec)
        for k in self.keys:
            v = clean.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and not math.isfinite(v):
                del clean[k]
                self.n_rejected += 1
                self.rejected[k] = self.rejected.get(k, 0) + 1
                if on_reject is not None:
                    on_reject(int(step), k, float(v))
        return clean
