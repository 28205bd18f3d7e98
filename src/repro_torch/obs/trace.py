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
import time
from typing import List, Optional

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


# the range around each backward pass of a training step (tracing on):
# a trace's backward windows, which ``benchmarks.overlap_check --bwd``
# reads
BACKWARD_SPAN = "train.backward"


def scope(name: str):
    """A ``record_function`` range named ``name`` when tracing is on, the
    shared nullcontext otherwise."""
    if not _ENABLED:
        return _NULL
    from torch.profiler import record_function
    return record_function(name)


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
