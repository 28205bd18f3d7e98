"""Trace spans: executor op scopes and host wall-clock spans.

  * **Op scopes** (:func:`op_scope`) — ``torch.profiler.record_function``
    ranges that the plan and pipelined executors open around each half
    of every collective op (the compress point and launch; the wait,
    decompress and combine).  A kernel launched inside a range is tied to
    it in a ``torch.profiler`` trace through its launch's correlation id,
    so :mod:`repro_torch.obs.profile` attributes each device event to its
    (plan, bucket, stage, kind, tier) grid point — the grid
    ``repro_torch.plan.cost.pipeline_breakdown`` prices.  The ranges are
    host-side annotations only: the ``torch.distributed`` calls and the
    kernels are the same with tracing on and off
    (``tests/test_torch_obs.py`` counts the calls at their boundary).
    Scopes are off by default and one shared ``nullcontext`` when
    disabled.

  * **Host spans** (:class:`Tracer`) — wall-clock timed regions of the
    driver (a training-step window, a checkpoint save, a drift probe),
    emitted as ``span`` events to a telemetry sink and opened as
    ``record_function`` ranges, so they also show on the host track of a
    profiler trace.  A span around asynchronously launched CUDA work
    measures the launches, not the device: drivers that want honest step
    timing span a WINDOW that ends at a host sync (the batched metric
    fetch) and record ``n`` steps per window.

  * **Step spans** (:func:`scope` with the ``*_SPAN`` names below) —
    ``record_function`` ranges around each phase of a training step:
    ``train.forward`` (each microbatch's loss), ``train.backward``,
    ``model.block`` (one superblock; under recompute it opens again
    inside backward, on the autograd thread), ``optim.update`` (the whole
    update and the copy into ``x``), ``optim.exchange`` (the dp exchange;
    the ``obs::`` scopes nest inside it), ``optim.stats`` (the per-step
    statistics, their reductions included) and ``train.metrics`` (the
    step metrics' dp mean and the ``v_l1`` all-reduces).  Kineto records
    them on the device trace's clock, so each kernel and each idle gap
    of a trace falls to the span open on the host when it was launched.

  * **Collective counters** (:func:`count_collective`) — every
    ``torch.distributed`` call a training step makes, counted by the mesh
    axes of its group and its kind: the calls, and the bytes this rank
    sends by the collective's algorithm (the plan IR's
    ``wire_send_bytes`` convention: pairwise all_to_all, ring
    all_gather, all_reduce and reduce_scatter).  :func:`counters` reads
    them and :func:`reset_counters` clears them.

Scopes, spans and counters are live only while tracing is on
(:func:`set_tracing`); off, a scope is one shared ``nullcontext`` and a
count returns at once.

Span naming convention, the reference's letter for letter::

    obs::<plan>::s<stage>::<Kind>~<tier>          serial executor
    obs::<plan>::b<bucket>.s<stage>::<Kind>~<tier> pipelined executor

e.g. ``obs::pipe(flat/onebit)x4::b2.s1::AllGather~intra`` = bucket 2's
all_gather leg.  (The reference separates the tier with ``~`` because
JAX's name stack drops everything from an ``@``; the port keeps the
grammar so both packages' folds parse both packages' names.)
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence

_NULL = contextlib.nullcontext()
_ENABLED = False


def set_tracing(on: bool) -> None:
    """Globally enable/disable executor op scopes (process-wide; the
    driver flips it once per run)."""
    global _ENABLED
    _ENABLED = bool(on)


def tracing_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def tracing(on: bool = True):
    """Scoped :func:`set_tracing` (tests use this)."""
    prev = _ENABLED
    set_tracing(on)
    try:
        yield
    finally:
        set_tracing(prev)


def span_name(plan_name: str, stage: int, kind: str, tier: str,
              bucket: Optional[int] = None) -> str:
    b = f"b{bucket}." if bucket is not None else ""
    return f"obs::{plan_name}::{b}s{stage}::{kind}~{tier}"


def op_scope(plan_name: str, stage: int, op, bucket: Optional[int] = None):
    """Context manager naming one collective op's trace range; the shared
    nullcontext when tracing is disabled (no allocation, no overhead on
    the default path)."""
    if not _ENABLED:
        return _NULL
    from torch.profiler import record_function
    return record_function(span_name(plan_name, stage, op.kind, op.tier,
                                     bucket))


# the ranges around the phases of a training step (tracing on); the
# backward windows are what ``benchmarks.overlap_check --bwd`` reads
FORWARD_SPAN = "train.forward"
BACKWARD_SPAN = "train.backward"
BLOCK_SPAN = "model.block"
UPDATE_SPAN = "optim.update"
EXCHANGE_SPAN = "optim.exchange"
STATS_SPAN = "optim.stats"
METRICS_SPAN = "train.metrics"
STEP_SPANS = (FORWARD_SPAN, BACKWARD_SPAN, BLOCK_SPAN, UPDATE_SPAN,
              EXCHANGE_SPAN, STATS_SPAN, METRICS_SPAN)


def scope(name: str):
    """A ``record_function`` range named ``name`` when tracing is on, the
    shared nullcontext otherwise."""
    if not _ENABLED:
        return _NULL
    from torch.profiler import record_function
    return record_function(name)


# torch.distributed function -> the collective's kind, by the reference's
# HLO op names (``analysis.roofline.ByteCounter`` shares the table)
COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "all_gather_single": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}

_COUNTS: Dict[str, Dict[str, List[float]]] = {}
_COUNTS_LOCK = threading.Lock()


def sent_bytes(kind: str, nbytes: int, n: int) -> float:
    """Bytes one of ``n`` ranks sends in a collective of ``kind`` whose
    input on this rank is ``nbytes``, as the plan IR's
    ``wire_send_bytes``: all_to_all and reduce_scatter (n - 1) / n of
    it, a ring all_gather its chunk n - 1 times, a ring all_reduce
    2 (n - 1) / n."""
    if kind == "all-gather":
        return float(nbytes * (n - 1))
    share = (n - 1) / max(n, 1)
    return 2.0 * nbytes * share if kind == "all-reduce" else nbytes * share


def count_collective(fn: str, tensor, axes: Sequence[str], n: int
                     ) -> None:
    """Count one ``torch.distributed.<fn>`` call on the group of mesh
    ``axes`` (``n`` ranks) whose input on this rank is ``tensor``.  A
    no-op while tracing is off."""
    if not _ENABLED:
        return
    kind = COLLECTIVE_KINDS[fn]
    sent = sent_bytes(kind, tensor.numel() * tensor.element_size(), n)
    with _COUNTS_LOCK:
        row = _COUNTS.setdefault("+".join(axes), {}).setdefault(
            kind, [0, 0.0])
        row[0] += 1
        row[1] += sent


def counters() -> Dict[str, Dict[str, Dict[str, float]]]:
    """``{axes: {kind: {"calls", "bytes"}}}`` counted since the last
    :func:`reset_counters` (axes joined by ``+``: ``dp``, ``model``,
    ``pod+data``)."""
    with _COUNTS_LOCK:
        return {axes: {kind: {"calls": c, "bytes": b}
                       for kind, (c, b) in kinds.items()}
                for axes, kinds in _COUNTS.items()}


def reset_counters() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


class Tracer:
    """Host-side wall-clock spans, recorded and (optionally) emitted as
    ``span`` events to a telemetry sink.

    Spans nest (the tracer keeps a depth stack, recorded as ``depth`` on
    each span, with monotonic ``t_mono0``/``t_mono1`` endpoints).  A body
    that RAISES still ends its span: the record carries ``ok: false`` and
    a ``warning`` event marks the abnormal close."""

    def __init__(self, sink=None):
        self.sink = sink
        self.spans: List[dict] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, stream: str = "host", **attrs):
        """Time a region; ``attrs`` ride on the span event (``step``,
        ``n``, ``op_kind``, ...)."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        wall0 = time.time()
        depth = self._depth
        self._depth = depth + 1
        exc: Optional[BaseException] = None
        try:
            with record_function(name):
                yield
        except BaseException as e:
            exc = e
            raise
        finally:
            self._depth = depth
            t1 = time.perf_counter()
            rec = {"name": name, "stream": stream, "t_start": wall0,
                   "dur": t1 - t0, "ok": exc is None, "depth": depth,
                   "t_mono0": t0, "t_mono1": t1, **attrs}
            self.spans.append(rec)
            if self.sink is not None:
                self.sink.emit("span", **rec)
                if exc is not None:
                    self.sink.emit("warning", what="span.abort",
                                   detail=f"span {name!r} closed by "
                                          f"{type(exc).__name__}")
