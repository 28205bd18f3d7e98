"""Per-rank device-memory ledger: predicted model + measured attribution.

1-bit Adam trades optimizer-state memory (the frozen ``v``, one EF
residual slot per lossy hop) for communication.  This module prices both
sides per rank, itemized.  The port of ``repro/obs/mem.py``.

**Predicted** — :func:`predict_ledger` builds a :class:`MemoryLedger`
from the same declarations everything else derives from:

  * ``params`` / ``grads`` — exact parameter bytes from
    :mod:`repro_torch.analysis.model_math`, and the padded flat f32
    gradient buffer;
  * ``opt_state`` — the ``SlotSpec`` registry priced through
    :func:`repro_torch.state.state_bytes` for this run's (optimizer,
    layout, topology);
  * ``wire`` — per-bucket staging buffers with a LIVE WATERMARK over
    ``pipeline_breakdown``'s scheduled intervals
    (:func:`repro_torch.plan.wire_watermark`): the peak concurrent
    buckets in flight, not the sum over buckets;
  * ``activations`` — the fwd+bwd live-set estimate
    (:func:`repro_torch.analysis.model_math.activation_bytes`).

**Measured** — the reference reads XLA's ``memory_analysis()`` of a
compiled step; an eager step has no such analysis, so
:class:`StepMemory` reads the CUDA caching allocator around ONE eager
step instead: ``reset_peak_memory_stats``, ``allocated_bytes.all.current``
before the step (its arguments: everything resident), and
``allocated_bytes.all.peak`` / ``.current`` after it (outputs: what the
step left resident beyond its arguments; temporaries: the rest of the
peak).  :func:`attribute_compiled` maps outputs + temporaries onto the
ledger categories with an explicit residual (attributed + residual ≡
total).  :class:`LiveSampler` reads ``torch.cuda.memory_stats()`` once
per log window (the host process's RSS on the CPU).

Everything folds into the ``memory`` event kind (the measured step under
the schema's existing ``compiled`` kind, ``program`` = ``warmup`` or
``compressed``), the report's memory section and ``--diff`` rows,
``mem_*`` BENCH metrics and the :meth:`HealthMonitor.observe_memory`
verdicts.  Host-side only: nothing here touches a tensor of the step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

MEMORY_MODES = ("off", "on")

# ledger categories, in report order
MEM_CATEGORIES = ("params", "grads", "opt_state", "wire", "activations")

SOURCE = "repro_torch.obs.mem"


# --------------------------------------------------------------------------
# predicted side — the MemoryLedger
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryLedger:
    """Itemized per-rank memory prediction (bytes per category)."""

    categories: Mapping[str, float]
    detail: Mapping[str, str] = dataclasses.field(default_factory=dict)
    capacity_bytes: Optional[float] = None

    @property
    def total_bytes(self) -> float:
        return float(sum(self.categories.values()))

    @property
    def headroom_frac(self) -> Optional[float]:
        """Predicted peak as a fraction of capacity (None = unknown)."""
        if not self.capacity_bytes:
            return None
        return self.total_bytes / float(self.capacity_bytes)

    def rows(self):
        """(category, bytes, fraction-of-total, note) report rows."""
        total = self.total_bytes or 1.0
        return [(name, float(b), float(b) / total,
                 self.detail.get(name, ""))
                for name, b in self.categories.items()]

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "categories": {k: float(v) for k, v in
                           self.categories.items()},
            "total_bytes": self.total_bytes,
        }
        if self.capacity_bytes:
            out["capacity_bytes"] = float(self.capacity_bytes)
            out["headroom_frac"] = self.headroom_frac
        return out

    def event_fields(self) -> Dict[str, object]:
        """Fields of the ``memory`` event with ``kind="predicted"``."""
        fields = dict(kind="predicted", source=SOURCE, **self.summary())
        fields["wire_watermark_bytes"] = float(
            self.categories.get("wire", 0.0))
        fields["state_bytes_per_rank"] = float(
            self.categories.get("opt_state", 0.0))
        return fields


def staging_bytes_serial(plan) -> float:
    """Wire/staging bytes of a SERIAL plan execution: the sum of its ops'
    per-device operand payloads (consecutive stages' buffers coexist
    across the handoff, as ``repro_torch.plan.bucket_staging_bytes``
    prices each bucket)."""
    return float(sum(op.payload_bytes for op in plan.ops))


def wire_ledger_bytes(plan, comp=None, n_buckets: int = 1,
                      n_total: int = 1, block: int = 4096,
                      spec=None, ready=None) -> Tuple[float, str]:
    """(watermark bytes, note) of the wire category for one exchange.

    Serial runs (or when the pipelined timeline cannot be priced — no
    compressor or no ClusterSpec) take the serial sum, exact for one
    bucket and conservative otherwise.  ``ready`` (per-bucket backward
    ready times, backward overlap) reprices the timeline with the bwd
    producer stream; a ``ready`` list of another length than the clamped
    bucket count falls back to the barrier schedule."""
    if plan is None:
        return 0.0, "no plan"
    serial = staging_bytes_serial(plan)
    if n_buckets <= 1 or comp is None or spec is None:
        return serial, "serial staging (sum of op payloads)"
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.plan.cost import (bucket_staging_bytes,
                                       pipeline_breakdown, wire_watermark)
    bk = Bucketer.for_exchange(plan.d, max(n_total, 1), block, n_buckets)
    # the kernel path the device implies, as the tuner prices it
    pplan = lower_to_pipelined(plan, comp, bk, use_kernel=(
        spec.device.runs_kernels and comp.has_kernel))
    if ready is not None and len(ready) != pplan.n_buckets:
        ready = None  # bucket clamp changed the count; fall back
    bd = pipeline_breakdown(pplan, spec, ready=ready)
    per_bucket = bucket_staging_bytes(pplan)
    wm = wire_watermark(bd["intervals"], per_bucket)
    note = (f"live watermark over {pplan.n_buckets} bucket(s) "
            f"(sum {sum(per_bucket):.0f} B)")
    if ready is not None:
        note += ", bwd-overlap schedule"
    return wm, note


def predict_ledger(cfg, dp_sizes: Sequence[int] = (1,), *, optim=None,
                   layout: str = "replicated", topology: str = "flat",
                   block: int = 4096, n_buckets: int = 1,
                   batch_global: int = 1, seq: int = 1, plan=None,
                   spec=None, capacity_bytes: Optional[float] = None,
                   param_dtype_bytes: int = 4, ready=None,
                   tp: int = 1) -> MemoryLedger:
    """The predicted per-rank ledger of one training run on a mesh of
    ``dp_sizes`` (two sizes = pods x data) and a model axis of ``tp``: a
    model rank's shards, its flat vector and state, and its share of the
    activations.

    ``plan`` is the compressed exchange's :class:`~repro_torch.plan.CommPlan`
    (``launch.train.run_plans`` builds it; None prices the wire category
    at zero) and ``spec`` the :class:`~repro_torch.plan.ClusterSpec`
    whose links and device schedule the pipelined watermark timeline."""
    from repro_torch.analysis.model_math import activation_bytes, param_bytes
    from repro_torch.launch.mesh import mesh_axes, pod_split
    from repro_torch.state import StateLayout, state_bytes
    from repro_torch.train.step import flat_dim, segment_info
    dp_sizes = tuple(int(s) for s in dp_sizes)
    n_dp = max(math.prod(dp_sizes), 1)
    d = flat_dim(cfg, n_dp, block, tp)
    n_srv, n_outer = n_dp, 1
    if topology == "hier" and len(dp_sizes) > 1:
        _, _, n_srv, n_outer = pod_split(mesh_axes(dp_sizes), dp_sizes)
    ctx = StateLayout(d=d, n_dp=n_dp, n_srv=n_srv, n_outer=n_outer,
                      n_segments=segment_info(cfg, d, tp).n,
                      dp_sizes=dp_sizes, tp=tp)
    if optim is None:
        from repro_torch.optim.base import TwoStageOptimizer
        optim = TwoStageOptimizer()
    slots = optim.state_slots(layout)
    pbytes = float(param_bytes(cfg, tp, param_dtype_bytes))
    # the padded flat f32 gradient buffer is the gradient's steady-state
    # residency
    gbytes = float(d) * 4.0
    sbytes = float(state_bytes(slots, ctx))
    comp = getattr(optim, "compressor", None)
    wbytes, wire_note = wire_ledger_bytes(
        plan, comp, n_buckets=n_buckets, n_total=n_dp, block=block,
        spec=spec, ready=ready)
    b_local = max(batch_global // n_dp, 1)
    abytes = activation_bytes(cfg, b_local, seq, tp)
    cats = {"params": pbytes, "grads": gbytes, "opt_state": sbytes,
            "wire": wbytes, "activations": abytes}
    detail = {
        "params": f"{param_dtype_bytes}B x per-model-rank leaves "
                  f"(tp={tp})",
        "grads": f"flat f32 exchange buffer (d={d})",
        "opt_state": (f"{len(slots)} slot(s), layout={layout}, "
                      f"topology={topology}"),
        "wire": wire_note,
        "activations": f"fwd+bwd live-set estimate (b={b_local}, s={seq})",
    }
    return MemoryLedger(categories=cats, detail=detail,
                        capacity_bytes=capacity_bytes)


def capacity_of(device) -> Optional[float]:
    """Per-rank capacity bytes of a DeviceSpec or preset name (None when
    unknown)."""
    from repro_torch.perf.device import as_device
    cap = as_device(device).hbm_capacity
    return float(cap) if cap else None


# --------------------------------------------------------------------------
# measured side — one eager step's allocator reading + live samples
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompiledMemory:
    """One step program's memory (per device), in the reference's terms:
    arguments, outputs, temporaries, aliases."""

    program: str
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int

    @property
    def per_device_bytes(self) -> int:
        """Peak residency the program needs: live arguments + outputs
        (minus aliases) + temporaries."""
        return (self.argument_bytes + self.output_bytes
                - self.alias_bytes + self.temp_bytes)

    def summary(self) -> Dict[str, object]:
        return {"program": self.program,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "per_device_bytes": self.per_device_bytes}

    def event_fields(self) -> Dict[str, object]:
        """Fields of the ``memory`` event with ``kind="compiled"``."""
        return {"kind": "compiled", "program": self.program,
                "argument_bytes": float(self.argument_bytes),
                "output_bytes": float(self.output_bytes),
                "temp_bytes": float(self.temp_bytes),
                "alias_bytes": float(self.alias_bytes),
                "peak_bytes": float(self.per_device_bytes),
                "source": SOURCE}


class StepMemory:
    """The caching allocator's measured peak around ONE eager step — the
    port's counterpart of the reference's ``memory_analysis()`` reader.

    ``with StepMemory("compressed", device) as sm: <the step>`` leaves
    ``sm.memory``: a :class:`CompiledMemory` whose arguments are the bytes
    allocated before the step, outputs the bytes it left allocated beyond
    them (0 when it freed more than it kept), temporaries the rest of the
    peak, aliases 0 — so ``per_device_bytes`` is the allocator's peak.
    On a device without allocator statistics (the CPU) ``sm.memory``
    stays None, as the reference's reader returns None on a backend with
    no analysis.  The reading resets the device's peak statistics."""

    def __init__(self, program: str, device):
        import torch
        self.program = program
        self.device = torch.device(device)
        self.memory: Optional[CompiledMemory] = None
        self._before = None

    def __enter__(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self._before = int(torch.cuda.memory_stats(self.device)
                               ["allocated_bytes.all.current"])
        return self

    def __exit__(self, *exc):
        import torch
        if self._before is None or exc[0] is not None:
            return False
        st = torch.cuda.memory_stats(self.device)
        peak = int(st["allocated_bytes.all.peak"])
        after = int(st["allocated_bytes.all.current"])
        out = max(after - self._before, 0)
        self.memory = CompiledMemory(
            program=self.program, argument_bytes=self._before,
            output_bytes=out, temp_bytes=peak - self._before - out,
            alias_bytes=0)
        return False


def attribute_compiled(ledger: MemoryLedger, cm: CompiledMemory,
                       metrics_bytes: float = 4096.0) -> Dict[str, object]:
    """Attribute a step's output + temporary bytes onto the ledger
    categories, with an explicit residual.

    Categories claim bytes greedily up to their predicted size, in the
    order params, opt_state, metrics, grads, wire, activations, clamped
    so ``attributed + residual == total`` holds as an identity: the
    residual is the UNEXPLAINED remainder, and over-prediction is
    reported separately as ``over_predicted_bytes``."""
    total = float(cm.output_bytes + cm.temp_bytes)
    predicted = {
        "params": float(ledger.categories.get("params", 0.0)),
        "opt_state": float(ledger.categories.get("opt_state", 0.0)),
        "metrics": float(metrics_bytes),
        "grads": float(ledger.categories.get("grads", 0.0)),
        "wire": float(ledger.categories.get("wire", 0.0)),
        "activations": float(ledger.categories.get("activations", 0.0)),
    }
    attribution: Dict[str, float] = {}
    remaining = total
    for name, want in predicted.items():
        take = min(max(want, 0.0), remaining)
        attribution[name] = take
        remaining -= take
    return {
        "program": cm.program,
        "compiled_bytes": total,
        "attribution": attribution,
        "attributed_bytes": total - remaining,
        "residual_bytes": remaining,
        "residual_frac": remaining / total if total > 0 else 0.0,
        "over_predicted_bytes": max(sum(predicted.values()) - total, 0.0),
    }


def attribution_event_fields(ledger: MemoryLedger, cm: CompiledMemory,
                             metrics_bytes: float = 4096.0
                             ) -> Dict[str, object]:
    """One ``memory`` event (``kind="compiled"``) carrying both the raw
    step reading and the ledger attribution."""
    att = attribute_compiled(ledger, cm, metrics_bytes=metrics_bytes)
    fields = cm.event_fields()
    fields["attribution"] = {k: float(v) for k, v in
                             att["attribution"].items()}
    fields["attributed_bytes"] = float(att["attributed_bytes"])
    fields["residual_bytes"] = float(att["residual_bytes"])
    fields["residual_frac"] = float(att["residual_frac"])
    return fields


class LiveSampler:
    """Per-log-window live memory samples.

    On a CUDA device, the caching allocator's statistics
    (``allocated_bytes.all.current`` / ``.peak``); on the CPU, the host
    process's RSS through psutil, with the peak tracked here.  Host-side
    only, so ``--memory on`` leaves the step untouched."""

    def __init__(self, device="cpu"):
        import torch
        self.device = torch.device(device)
        self._peak = 0.0

    @property
    def peak_bytes(self) -> Optional[float]:
        """Largest sample seen so far (None before the first)."""
        return self._peak or None

    def sample(self, step: Optional[int] = None) -> Optional[dict]:
        """Fields of one ``memory`` event (``kind="live"``), or None when
        no source is available."""
        import torch
        fields: Dict[str, object] = {"kind": "live", "source": SOURCE}
        if step is not None:
            fields["step"] = int(step)
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            in_use = float(st["allocated_bytes.all.current"])
            peak = float(st["allocated_bytes.all.peak"])
            fields["device"] = "cuda"
        else:
            rss = _process_rss()
            if rss is None:
                return None
            in_use = peak = float(rss)
            fields["device"] = "host-rss"
        self._peak = max(self._peak, peak)
        fields["bytes_in_use"] = in_use
        fields["peak_bytes_in_use"] = self._peak
        return fields


def _process_rss() -> Optional[int]:
    try:
        import psutil
    except ImportError:
        return None
    return int(psutil.Process().memory_info().rss)


# --------------------------------------------------------------------------
# BENCH metrics + report rows
# --------------------------------------------------------------------------

def mem_metrics(ledger: MemoryLedger,
                compiled: Optional[CompiledMemory] = None,
                live_peak: Optional[float] = None) -> Dict[str, float]:
    """Perf-ledger cells for one run.  ``mem_*`` names are the predicted
    byte counts and the measured step's, the reference's names
    (``mem_compiled_*`` for the measured step); the live sample keeps a
    non-``mem_`` name (``live_bytes_peak``)."""
    out = {
        "mem_state_bytes": float(ledger.categories.get("opt_state", 0.0)),
        "mem_wire_watermark_bytes": float(
            ledger.categories.get("wire", 0.0)),
        "mem_predicted_total_bytes": ledger.total_bytes,
    }
    if compiled is not None:
        out["mem_compiled_temp_bytes"] = float(compiled.temp_bytes)
        out["mem_compiled_output_bytes"] = float(compiled.output_bytes)
        out["mem_compiled_argument_bytes"] = float(
            compiled.argument_bytes)
    if live_peak:
        out["live_bytes_peak"] = float(live_peak)
    return out


def format_rows(ledger: MemoryLedger, attributions=()) -> str:
    """Human-readable ledger rows: predicted categories, then each
    measured step's attribution."""
    lines = ["memory ledger (per rank, predicted):"]
    for name, nbytes, frac, note in ledger.rows():
        lines.append(f"  {name:12s} {nbytes / 2 ** 20:12.2f} MiB "
                     f"({frac:6.1%})  {note}")
    cap = ledger.capacity_bytes
    lines.append(f"  {'total':12s} {ledger.total_bytes / 2 ** 20:12.2f} MiB"
                 + (f"  of {cap / 2 ** 30:.1f} GiB capacity "
                    f"({ledger.headroom_frac:.1%})" if cap else ""))
    for att in attributions:
        lines.append(
            f"  measured [{att['program']}]: "
            f"{att['compiled_bytes'] / 2 ** 20:.2f} MiB temp+output; "
            f"attributed {att['attributed_bytes'] / 2 ** 20:.2f} MiB, "
            f"residual {att['residual_bytes'] / 2 ** 20:.2f} MiB "
            f"({att['residual_frac']:.1%})")
    return "\n".join(lines)
