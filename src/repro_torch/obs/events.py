"""Typed event schema of the structured run telemetry (repro_torch.obs).

The port's own copy of ``repro/obs/events.py``: the schema below is
unchanged, field for field, so the reference's ``repro.obs.report`` and
``results/bench_compare.py`` read the port's logs and ledgers.

A telemetry log is a JSONL file: one JSON object per line, each with a
``type`` naming its event kind, a ``t`` host wall-clock timestamp
(seconds since the epoch), and the kind's typed fields.  The schema
below is the single source of truth three consumers share:

  * the writers — ``repro_torch.launch.train --telemetry`` and the
    port's benchmarks (``variance_stability``, ``comm_fraction``) build
    records through :func:`make_event`, which validates at emit time;
  * the reader — ``repro_torch.obs.report`` folds a log into summary
    tables and re-validates with ``--validate``;
  * tests — ``tests/test_torch_obs.py`` holds it to the reference's.

Event kinds
-----------

``run_meta``     one per run: the resolved configuration (optimizer,
                 compressor, topology, bucket count, mesh, ...).
``plan``         byte/time accounting of an executed ``CommPlan``: the
                 per-tier wire bytes (``*_hlo_bytes``, the reference's
                 field names; the port counts them at the
                 ``torch.distributed`` call boundary), the predicted α-β
                 time, and — for pipelined runs — the three-stream
                 breakdown.
``comm``         one comm-vs-compute ratio point (predicted or
                 measured): the quantity of the paper's Table 1.
``step``         per-training-step metrics (loss, the Fig. 2 fused
                 variance norm ``v_l1``, EF-residual norms, ...).
``transition``   a stage or sync edge: warmup→compressed (the
                 variance-freeze switch) or 0/1 Adam sync skips.
``warning``      host-side anomaly (e.g. a non-finite variance ratio
                 the auto-freeze guard rejected).
``span``         one timed region: host wall-clock spans from the
                 driver, or probe-measured collective-op times (the
                 drift monitor's input).
``drift``        one predicted-vs-measured verdict of the cost-model
                 drift monitor, per (op kind, tier).
``recalibration``pointer to an emitted ``ClusterSpec.from_measured``
                 JSON when drift exceeded the threshold.
``profile``      one folded ``torch.profiler`` window
                 (:mod:`repro_torch.obs.profile`): measured wall clock,
                 attributed + residual split, per-stream overlap audit,
                 and the per-(plan, bucket, stage, kind, tier) cells.
``fidelity``     one audited step of the per-segment training-signal
                 probe (:mod:`repro_torch.obs.audit`): shadow-vs-frozen
                 variance drift, compressed-vs-raw cosine similarity
                 and sign agreement, EF-residual mass — each a
                 per-segment list plus whole-model scalars.
``health``       the :class:`repro_torch.obs.audit.HealthMonitor` verdict
                 folded from one ``fidelity`` record + the trailing
                 loss window: ``ok`` or a list of named verdicts
                 (``variance_drift``, ``ef_blowup``, ``non_finite``,
                 ``loss_spike``, ``mem_headroom``, ``mem_growth``).
``memory``       one per-rank device-memory ledger record
                 (:mod:`repro_torch.obs.mem`), disambiguated by
                 ``kind``: ``predicted`` (the itemized MemoryLedger —
                 params/grads/opt_state/wire/activations categories vs
                 device capacity), ``compiled`` (one step program's
                 argument/output/temp/alias bytes — in the port the
                 caching allocator's measured peak around one eager
                 step — attributed back onto the ledger categories with
                 an explicit residual), or ``live`` (a
                 ``torch.cuda.memory_stats()`` / host-RSS sample taken
                 once per log window).

Besides the JSONL event stream, this module also owns the **perf-ledger
record schema** (``BENCH_*.json`` files — :mod:`repro_torch.obs.bench`
reads and writes them): one record per measured (bench, config, mesh,
pipeline, kernels) cell, identity fields required, every metric a
plain number.  ``results/bench_compare.py`` compares two such ledgers.

Validation policy: the per-kind REQUIRED fields must be present with
the right JSON types; OPTIONAL fields are type-checked when present;
unknown extra fields are allowed but must be JSON scalars (so logs stay
greppable and forward-compatible).
"""
from __future__ import annotations

import numbers
import time
from typing import Dict, Iterable, Tuple

_NUM = numbers.Real          # int or float (bools are excluded explicitly)
_SCALAR = (str, int, float, bool, type(None))


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


_CHECKS = {
    "num": _is_num,
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "str": lambda v: isinstance(v, str),
    "bool": lambda v: isinstance(v, bool),
    "list": lambda v: isinstance(v, list),
    "dict": lambda v: isinstance(v, dict),
}

# metric fields a ``step`` event may carry (all host floats)
STEP_METRICS = ("loss", "acc", "aux", "total", "v_l1", "grad_norm",
                "momentum_norm", "worker_err_norm", "server_err_norm",
                "lr", "ratio")

# type -> (required {field: typename}, optional {field: typename})
EVENT_SCHEMA: Dict[str, Tuple[Dict[str, str], Dict[str, str]]] = {
    "run_meta": (
        {"optimizer": "str", "compressor": "str", "topology": "str",
         "n_buckets": "int"},
        {"arch": "str", "layout": "str", "use_kernel": "bool",
         "overlap_bwd": "bool",
         "mesh": "list", "steps": "int", "block_size": "int",
         "cluster": "str", "device": "str", "seed": "int",
         "recipe": "str", "source": "str"},
    ),
    "plan": (
        {"name": "str", "stage": "str", "d": "int",
         "intra_hlo_bytes": "num", "cross_hlo_bytes": "num"},
        {"n_buckets": "int", "wire_send_bytes": "num",
         "dci_bytes_per_pod": "num", "t_predicted": "num",
         "t_compute_predicted": "num", "breakdown": "dict",
         "ops": "list", "overlap_bwd": "bool", "t_bwd": "num",
         # per-bucket predicted backward ready times, bucket order
         "ready_times": "list"},
    ),
    "comm": (
        {"t_comm": "num", "t_compute": "num"},
        {"label": "str", "n": "int", "gbps": "num", "frac": "num",
         "compressor": "str", "stage": "str", "bytes": "num",
         "source": "str"},
    ),
    "step": (
        {"step": "int"},
        {"stage": "str", "sync": "bool", "optimizer": "str",
         **{m: "num" for m in STEP_METRICS}},
    ),
    "transition": (
        {"step": "int", "kind": "str", "to": "str"},
        {"frm": "str", "ratio": "num", "mode": "str"},
    ),
    "warning": (
        {"what": "str"},
        {"step": "int", "value": "num", "detail": "str"},
    ),
    "span": (
        {"name": "str", "dur": "num"},
        {"stream": "str", "t_start": "num", "step": "int", "n": "int",
         "bucket": "int", "stage": "int", "op_kind": "str",
         "tier": "str", "payload_bytes": "num", "group": "int",
         "ok": "bool", "depth": "int"},
    ),
    "profile": (
        {"n_steps": "int", "t_window": "num", "t_attributed": "num",
         "t_residual": "num"},
        {"s_per_step": "num", "comm_fraction": "num",
         "overlap_efficiency": "num", "roofline_fraction": "num",
         "bytes_per_step": "num", "n_cells": "int",
         "n_unattributed": "int", "cells": "list", "streams": "dict",
         "audit_vs_predicted": "list", "source": "str",
         "exposed_comm_s": "num",
         # measured-vs-predicted per-bucket ready-order rows
         "ready_order": "list"},
    ),
    "drift": (
        {"op_kind": "str", "tier": "str", "n_samples": "int",
         "t_measured": "num", "t_predicted": "num", "ratio": "num",
         "drifting": "bool"},
        {"threshold": "num"},
    ),
    "recalibration": (
        {"op_overhead": "num"},
        {"path": "str", "intra": "dict", "cross": "dict",
         "reason": "str", "n_inner": "int", "n_outer": "int"},
    ),
    "fidelity": (
        {"step": "int", "n_segments": "int"},
        # per-segment lists (length n_segments, padding tail included)
        {"cos_sim": "list", "sign_agree": "list", "v_drift": "list",
         "v_l1_seg": "list", "worker_err_seg": "list",
         "server_err_seg": "list", "scale_seg": "list",
         # whole-model scalars + host-folded extrema of the lists
         "v_ratio": "num", "v_drift_max": "num", "v_drift_min": "num",
         "cos_sim_min": "num", "sign_agree_min": "num",
         "grad_norm": "num", "momentum_norm": "num",
         "worker_err_norm": "num", "server_err_norm": "num",
         "v_live": "num", "stage": "str", "source": "str"},
    ),
    "health": (
        {"step": "int", "ok": "bool"},
        {"verdicts": "list", "v_ratio": "num", "v_drift_max": "num",
         "err_growth": "num", "loss": "num", "loss_median": "num",
         "bytes_in_use": "num", "peak_bytes_in_use": "num",
         "capacity_bytes": "num", "headroom_frac": "num",
         "growth_frac": "num", "detail": "str", "source": "str"},
    ),
    "memory": (
        # kind: "predicted" | "compiled" | "live"
        {"kind": "str"},
        {# predicted: the itemized ledger
         "categories": "dict", "total_bytes": "num",
         "capacity_bytes": "num", "headroom_frac": "num",
         "wire_watermark_bytes": "num", "state_bytes_per_rank": "num",
         # compiled: one program's memory_analysis() + attribution
         "program": "str", "argument_bytes": "num",
         "output_bytes": "num", "temp_bytes": "num",
         "alias_bytes": "num", "peak_bytes": "num",
         "attribution": "dict", "attributed_bytes": "num",
         "residual_bytes": "num", "residual_frac": "num",
         # live: one per-window sample
         "step": "int", "bytes_in_use": "num",
         "peak_bytes_in_use": "num", "device": "str",
         "source": "str", "stage": "str"},
    ),
}

# transition kinds (the ``kind`` field of a "transition" event)
TRANSITION_KINDS = ("stage", "sync")

# the verdict names a "health" event's ``verdicts`` list may carry
# (repro_torch.obs.audit.HealthMonitor emits them); mem_* verdicts come
# from the live memory samples (repro_torch.obs.mem), not the fidelity
# probe
HEALTH_VERDICTS = ("variance_drift", "ef_blowup", "non_finite",
                   "loss_spike", "mem_headroom", "mem_growth")

# the ``kind`` values a "memory" event may carry (repro_torch.obs.mem)
MEMORY_KINDS = ("predicted", "compiled", "live")


def validate_event(rec: dict) -> dict:
    """Check one record against the schema; returns it, raises
    ``ValueError`` with a pointed message otherwise."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be an object, got {type(rec).__name__}")
    etype = rec.get("type")
    if etype not in EVENT_SCHEMA:
        raise ValueError(f"unknown event type {etype!r}; "
                         f"known: {sorted(EVENT_SCHEMA)}")
    if "t" in rec and not _is_num(rec["t"]):
        raise ValueError(f"{etype}: timestamp 't' must be a number, "
                         f"got {rec['t']!r}")
    required, optional = EVENT_SCHEMA[etype]
    for field, tname in required.items():
        if field not in rec:
            raise ValueError(f"{etype}: missing required field {field!r}")
        if not _CHECKS[tname](rec[field]):
            raise ValueError(f"{etype}.{field}: expected {tname}, "
                             f"got {rec[field]!r}")
    for field, tname in optional.items():
        if field in rec and rec[field] is not None \
                and not _CHECKS[tname](rec[field]):
            raise ValueError(f"{etype}.{field}: expected {tname}, "
                             f"got {rec[field]!r}")
    for field, value in rec.items():
        if field in ("type", "t") or field in required or field in optional:
            continue
        if not isinstance(value, _SCALAR):
            raise ValueError(
                f"{etype}.{field}: unknown fields must be JSON scalars, "
                f"got {type(value).__name__}")
    return rec


def make_event(etype: str, t: float = None, **fields) -> dict:
    """Build + validate one event record (adds the ``t`` timestamp)."""
    rec = {"type": etype, "t": time.time() if t is None else float(t)}
    rec.update(fields)
    return validate_event(rec)


def validate_records(records: Iterable[dict]) -> int:
    """Validate a record stream; returns the count, raises on the first
    invalid record (with its index in the message)."""
    n = 0
    for i, rec in enumerate(records):
        try:
            validate_event(rec)
        except ValueError as e:
            raise ValueError(f"record {i}: {e}") from None
        n += 1
    return n


# --------------------------------------------------------------------------
# BENCH perf-ledger record schema (repro_torch.obs.bench reads/writes it)
# --------------------------------------------------------------------------

# the ledger file's schema tag; bump on incompatible record changes
BENCH_SCHEMA = "repro.obs.bench/v1"

# the identity of one measured cell: which benchmark, on which config,
# on what mesh, with which pipeline bucket count and kernel choice —
# results/bench_compare.py matches baseline vs candidate on this key
BENCH_KEY_FIELDS: Dict[str, str] = {
    "bench": "str", "config": "str", "mesh": "list",
    "pipeline": "int", "kernels": "bool",
}


def bench_key(rec: dict) -> tuple:
    """The comparable identity tuple of one ledger record."""
    return (rec["bench"], rec["config"], tuple(rec["mesh"]),
            rec["pipeline"], rec["kernels"])


def validate_bench_record(rec: dict) -> dict:
    """One perf-ledger record: the identity fields above (required,
    typed) plus a ``metrics`` dict of plain numbers — nothing else, so
    every ledger cell diffs field-by-field."""
    if not isinstance(rec, dict):
        raise ValueError(
            f"bench record must be an object, got {type(rec).__name__}")
    for field, tname in BENCH_KEY_FIELDS.items():
        if field not in rec:
            raise ValueError(f"bench record: missing key field {field!r}")
        if not _CHECKS[tname](rec[field]):
            raise ValueError(f"bench.{field}: expected {tname}, "
                             f"got {rec[field]!r}")
    if not all(isinstance(m, (int, str)) for m in rec["mesh"]):
        raise ValueError(f"bench.mesh: expected axis sizes, "
                         f"got {rec['mesh']!r}")
    metrics = rec.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError("bench record: 'metrics' dict is required")
    for name, value in metrics.items():
        if not _is_num(value):
            raise ValueError(f"bench.metrics[{name!r}]: expected a "
                             f"number, got {value!r}")
    extra = set(rec) - set(BENCH_KEY_FIELDS) - {"metrics", "t"}
    if extra:
        raise ValueError(f"bench record: unknown fields {sorted(extra)}")
    return rec
