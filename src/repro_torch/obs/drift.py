"""Cost-model drift monitor: predicted vs measured collective times.

The α-β model of :mod:`repro_torch.plan.cost` drives every
``--topology/--pipeline/--overlap-bwd auto`` decision, but its numbers are
presets or a one-off ``benchmarks.comm_sweep`` calibration.
:class:`DriftMonitor` checks them against the fabric a run lands on.  The
port of ``repro/obs/drift.py``:

  1. feed it measured per-op samples — ``observe(kind, tier, n,
     payload_bytes, seconds)`` — from :func:`probe_plan` (times each
     collective of a resolved plan in isolation over
     ``torch.distributed``), profiler spans, or an external log;
  2. every sample is priced by the formula the tuner uses
     (:func:`repro_torch.plan.cost.op_time_kind`) against the run's
     :class:`~repro_torch.plan.cost.ClusterSpec`;
  3. ``report()`` aggregates per (op kind, tier) and flags drift where
     the mean measured/predicted ratio leaves ``[1/(1+threshold),
     1+threshold]`` with at least ``min_samples`` samples;
  4. when anything drifts, ``recalibrate()`` least-squares refits
     (op_overhead, α/β per tier) from the samples through
     :func:`repro_torch.plan.cost.op_coeffs_kind`, and
     ``emit_recalibration(path)`` writes the JSON
     ``ClusterSpec.from_measured`` reads.

The fit needs at least two collective kinds with different
latency/bandwidth coefficient ratios per tier to separate α from the
shared launch overhead; with fewer, ``recalibrate`` still returns a
clamped best-effort fit (which ``ClusterSpec.from_measured`` refuses when
its ``clamped`` list says so).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.plan.cost import ClusterSpec, op_coeffs_kind, op_time_kind

_KINDS = ("AllToAll", "AllGather", "AllReduce", "ReduceScatter",
          "Broadcast")


@dataclasses.dataclass(frozen=True)
class DriftSample:
    """One measured collective: what moved, where, and how long."""

    op_kind: str
    tier: str
    n: int
    payload_bytes: float
    seconds: float


def fit_linkspecs(samples: Sequence[DriftSample]) -> Dict[str, object]:
    """Joint lstsq fit of (op_overhead, α/β per tier) from measured
    samples — the drift-side twin of ``benchmarks.comm_sweep``'s fit, built
    on the cost model's own coefficient rows so the fitted spec
    reproduces the samples through ``op_time`` by construction.
    Negative solutions (noise) clamp to tiny positive values."""
    if not samples:
        raise ValueError("fit_linkspecs needs at least one sample")
    tiers = sorted({s.tier for s in samples})
    cols = 1 + 2 * len(tiers)
    rows, ts = [], []
    for s in samples:
        ov, al, ib = op_coeffs_kind(s.op_kind, s.n, s.payload_bytes)
        row = [ov] + [0.0] * (cols - 1)
        j = 1 + 2 * tiers.index(s.tier)
        row[j], row[j + 1] = al, ib
        rows.append(row)
        ts.append(s.seconds)
    x, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(ts), rcond=None)
    out: Dict[str, object] = {"op_overhead": float(max(x[0], 1e-9)),
                              "tiers": {}}
    for i, tier in enumerate(tiers):
        alpha = float(max(x[1 + 2 * i], 1e-9))
        inv_b = float(max(x[2 + 2 * i], 1e-15))
        out["tiers"][tier] = {"latency": alpha, "bandwidth": 1.0 / inv_b}
    return out


class DriftMonitor:
    """Accumulate measured op times; compare against ``spec``'s α-β
    predictions; emit a recalibration when they diverge."""

    def __init__(self, spec: ClusterSpec, threshold: float = 0.25,
                 min_samples: int = 3):
        if threshold <= 0.0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.spec = spec
        self.threshold = float(threshold)
        self.min_samples = max(int(min_samples), 1)
        self.samples: List[DriftSample] = []

    # --- feeding ----------------------------------------------------------
    def observe(self, op_kind: str, tier: str, n: int,
                payload_bytes: float, seconds: float) -> dict:
        """Record one measured collective; returns its residual record
        ``{t_measured, t_predicted, ratio}``."""
        if op_kind not in _KINDS:
            raise ValueError(f"unknown collective kind {op_kind!r}")
        s = DriftSample(op_kind, tier, int(n), float(payload_bytes),
                        float(seconds))
        self.samples.append(s)
        pred = self._predict(s)
        return {"t_measured": s.seconds, "t_predicted": pred,
                "ratio": s.seconds / pred if pred > 0 else float("inf")}

    def observe_op(self, op, seconds: float) -> dict:
        """Record a measured :class:`~repro_torch.plan.ir.CollectiveOp`."""
        return self.observe(op.kind, op.tier, op.n, op.payload_bytes,
                            seconds)

    def _predict(self, s: DriftSample) -> float:
        return op_time_kind(s.op_kind, s.tier, s.n, s.payload_bytes,
                            self.spec)

    # --- verdicts ---------------------------------------------------------
    def report(self) -> List[dict]:
        """Per-(op kind, tier) aggregation: mean measured/predicted and
        the drift verdict (see class docstring for the rule)."""
        groups: Dict[Tuple[str, str], List[DriftSample]] = {}
        for s in self.samples:
            groups.setdefault((s.op_kind, s.tier), []).append(s)
        out = []
        lo, hi = 1.0 / (1.0 + self.threshold), 1.0 + self.threshold
        for (kind, tier), ss in sorted(groups.items()):
            meas = float(np.mean([s.seconds for s in ss]))
            pred = float(np.mean([self._predict(s) for s in ss]))
            ratio = meas / pred if pred > 0 else float("inf")
            out.append({
                "op_kind": kind, "tier": tier, "n_samples": len(ss),
                "t_measured": meas, "t_predicted": pred, "ratio": ratio,
                "drifting": (len(ss) >= self.min_samples
                             and not lo <= ratio <= hi),
                "threshold": self.threshold,
            })
        return out

    @property
    def drifting(self) -> List[Tuple[str, str]]:
        """(op kind, tier) pairs currently over the drift threshold."""
        return [(r["op_kind"], r["tier"]) for r in self.report()
                if r["drifting"]]

    # --- recalibration ----------------------------------------------------
    def recalibrate(self) -> Dict[str, object]:
        """Refit α/β from the accumulated samples, in the
        ``ClusterSpec.from_measured`` JSON layout (``comm_sweep``'s
        format: ``intra``/``cross``/``op_overhead``/pod split)."""
        fit = fit_linkspecs(self.samples)
        tiers = fit["tiers"]
        return {
            "name": f"drift-recal({self.spec.name})",
            "intra": tiers.get("intra") or tiers.get("cross"),
            "cross": tiers.get("cross") if "intra" in tiers else None,
            "op_overhead": fit["op_overhead"],
            "n_inner": self.spec.n_inner, "n_outer": self.spec.n_outer,
            "samples": [dataclasses.asdict(s) for s in self.samples],
        }

    def emit_recalibration(self, path: str) -> Dict[str, object]:
        """Write the recalibration JSON; round-trips through
        ``ClusterSpec.from_measured(path)``."""
        out = self.recalibrate()
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        return out

    def events(self, emit_recal_path: Optional[str] = None) -> List[dict]:
        """The monitor's state as telemetry event field-dicts: one
        ``drift`` record per (kind, tier), plus a ``recalibration``
        record when anything drifts (written to ``emit_recal_path``
        when given)."""
        report = self.report()
        out = [("drift", r) for r in report]
        if any(r["drifting"] for r in report):
            recal = (self.emit_recalibration(emit_recal_path)
                     if emit_recal_path else self.recalibrate())
            fields = {k: recal[k] for k in ("op_overhead", "intra",
                                            "cross", "n_inner", "n_outer")
                      if recal.get(k) is not None}
            if emit_recal_path:
                fields["path"] = emit_recal_path
            fields["reason"] = ", ".join(
                f"{r['op_kind']}@{r['tier']} x{r['ratio']:.2f}"
                for r in report if r["drifting"])
            out.append(("recalibration", fields))
        return out


# --------------------------------------------------------------------------
# live probe: time a resolved plan's collectives over torch.distributed
# --------------------------------------------------------------------------

def _run_collective(op, bufs, group) -> None:
    """One blocking run of ``op``'s wire leg on zero buffers of its
    declared payload (each leaf as its bytes where gloo and NCCL have no
    16-bit integer type)."""
    import torch.distributed as dist

    from repro_torch.plan.executor import all_gather_into
    from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll,
                                     Broadcast, ReduceScatter)
    for send, recv in bufs:
        if isinstance(op, AllToAll):
            dist.all_to_all_single(recv, send, group=group)
        elif isinstance(op, AllGather):
            all_gather_into(recv, send, group=group)
        elif isinstance(op, AllReduce):
            dist.all_reduce(send, group=group)
        elif isinstance(op, ReduceScatter):
            dist.reduce_scatter_tensor(recv, send, group=group)
        elif isinstance(op, Broadcast):
            src = dist.get_global_rank(group, op.root) if group is not None \
                else op.root
            dist.broadcast(send, src=src, group=group)
        else:
            raise TypeError(f"no probe for {type(op).__name__}")


def _buffers(op, device):
    """(send, receive) zero tensors per payload leaf of ``op``."""
    import torch

    from repro_torch.plan.ir import AllGather, AllToAll, ReduceScatter
    bufs = []
    for w in op.payload:
        dtype = getattr(torch, w.dtype)
        send = torch.zeros(w.shape, dtype=dtype, device=device)
        if dtype == torch.uint16:
            send = send.view(torch.uint8)
        if isinstance(op, AllToAll):
            recv = torch.empty_like(send)
        elif isinstance(op, AllGather):
            recv = send.new_empty((op.n * send.shape[0],))
        elif isinstance(op, ReduceScatter):
            recv = send.new_empty((send.shape[0] // op.n,))
        else:
            recv = None
        bufs.append((send, recv))
    return bufs


def probe_plan(plan, device="cpu", iters: int = 4,
               repeats: int = 3) -> List[DriftSample]:
    """Time each collective op of ``plan`` in isolation on the process
    groups of its axes — the live sample source of :class:`DriftMonitor`
    (``benchmarks.comm_sweep``-style: the best of ``iters`` runs of the
    op's wire leg on its DECLARED payload, each run timed by CUDA events
    on NCCL and by the host clock on gloo).  Each op is measured
    ``repeats`` times (independent best-of-``iters`` samples), so one
    pass meets the monitor's default ``min_samples``.

    Every rank of the plan's groups must call it (the collectives are
    real).  An op with ``n <= 1`` or no axes moves no bytes and is
    skipped: a one-rank run probes nothing and returns no samples.
    """
    import torch

    from repro_torch.plan.executor import group_of

    device = torch.device(device)
    cuda = device.type == "cuda"
    samples: List[DriftSample] = []
    for op in plan.ops:
        if op.n <= 1 or not op.axes:
            continue
        group = group_of(op.axes)
        bufs = _buffers(op, device)
        _run_collective(op, bufs, group)   # connections outside the clock
        if cuda:
            torch.cuda.synchronize(device)
        for _ in range(max(repeats, 1)):
            best = float("inf")
            for _ in range(max(iters, 1)):
                if cuda:
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    _run_collective(op, bufs, group)
                    t1.record()
                    t1.synchronize()
                    secs = t0.elapsed_time(t1) / 1e3
                else:
                    t0 = time.perf_counter()
                    _run_collective(op, bufs, group)
                    secs = time.perf_counter() - t0
                best = min(best, secs)
            samples.append(DriftSample(op.kind, op.tier, op.n,
                                       float(op.payload_bytes), best))
    return samples
