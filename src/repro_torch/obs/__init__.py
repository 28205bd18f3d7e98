"""repro_torch.obs — structured run telemetry of the port.

The port of ``repro.obs``, module for module:

  * :mod:`repro_torch.obs.events` — the typed JSONL event schema and the
    BENCH record schema, unchanged from the reference, so either
    package's report reads either package's logs;
  * :mod:`repro_torch.obs.metrics` — :class:`TelemetrySink` (buffered
    JSONL writer) / :class:`NullSink` (the zero-cost disabled twin) and
    :class:`MetricBuffer`, the batched device→host metric path (one
    ``torch.cat`` and one copy per fetch, not one sync per scalar);
  * :mod:`repro_torch.obs.trace` — executor op scopes
    (``torch.profiler.record_function`` ranges on the
    ``obs::<plan>::[b<bucket>.]s<stage>::<Kind>~<tier>`` grid) and host
    wall-clock :class:`Tracer` spans;
  * :mod:`repro_torch.obs.drift` — :class:`DriftMonitor`,
    predicted-vs-measured α-β residuals against
    :mod:`repro_torch.plan.cost`, and :func:`probe_plan`, which times a
    plan's collectives over ``torch.distributed``;
  * :mod:`repro_torch.obs.profile` — fold a ``torch.profiler`` chrome
    trace (Kineto) onto the plan grid: each device event joined through
    its launch's correlation id to the innermost ``obs::`` range around
    the launch, the per-stream overlap audit, and the attribution report
    with an explicit unattributed residual;
  * :mod:`repro_torch.obs.bench` — the ``BENCH_<name>.json`` ledger
    writer/reader;
  * :mod:`repro_torch.obs.mem` — the per-rank device-memory ledger: a
    predicted :class:`MemoryLedger`, the caching allocator's measured
    peak around one eager step attributed onto its categories with an
    explicit residual, and per-window live samples;
  * :mod:`repro_torch.obs.audit` — the per-segment compression-fidelity
    and frozen-variance audit (:func:`make_audit_probe`),
    :class:`HealthMonitor` and :class:`FiniteGuard`;
  * :mod:`repro_torch.obs.report` — folds any log into tables
    (``python -m repro_torch.obs.report LOG [LOG_B]``).

Submodule attributes resolve lazily (PEP 562): ``repro_torch.obs.trace``
is imported by the executors on their hot path, and importing ``drift``
here would pull ``plan.cost`` into every executor import — the laziness
keeps ``import repro_torch.plan.executor`` cycle-free and cheap.
"""
from __future__ import annotations

_EXPORTS = {
    "EVENT_SCHEMA": "events",
    "STEP_METRICS": "events",
    "HEALTH_VERDICTS": "events",
    "MEMORY_KINDS": "events",
    "make_event": "events",
    "validate_event": "events",
    "validate_records": "events",
    "validate_bench_record": "events",
    "MetricBuffer": "metrics",
    "NullSink": "metrics",
    "TelemetrySink": "metrics",
    "as_sink": "metrics",
    "Tracer": "trace",
    "op_scope": "trace",
    "set_tracing": "trace",
    "span_name": "trace",
    "tracing": "trace",
    "tracing_enabled": "trace",
    "DriftMonitor": "drift",
    "DriftSample": "drift",
    "fit_linkspecs": "drift",
    "probe_plan": "drift",
    "attribution": "profile",
    "fold_profile": "profile",
    "fold_trace": "profile",
    "overlap_audit": "profile",
    "parse_scope": "profile",
    "AUDIT_MODES": "audit",
    "FiniteGuard": "audit",
    "HealthMonitor": "audit",
    "make_audit_probe": "audit",
    "MEMORY_MODES": "mem",
    "MEM_CATEGORIES": "mem",
    "MemoryLedger": "mem",
    "CompiledMemory": "mem",
    "LiveSampler": "mem",
    "attribute_compiled": "mem",
    "StepMemory": "mem",
    "mem_metrics": "mem",
    "predict_ledger": "mem",
    "bench_record": "bench",
    "load_ledger": "bench",
    "records_from_result": "bench",
    "write_ledger": "bench",
}

_SUBMODULES = ("events", "metrics", "trace", "drift", "report",
               "profile", "bench", "audit", "mem")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        mod = importlib.import_module(f"repro_torch.obs.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
