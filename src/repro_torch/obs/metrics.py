"""Telemetry sinks + the buffered device→host metric path.

Two pieces:

  * :class:`TelemetrySink` — a buffered JSONL writer of validated
    events (:mod:`repro_torch.obs.events`).  :class:`NullSink` is the
    disabled twin: every method is a no-op, so callers thread ONE sink
    object unconditionally and the telemetry layer costs nothing when
    off (``as_sink(None)`` returns it).

  * :class:`MetricBuffer` — the buffered host-transfer path for
    per-step device metrics.  Calling ``float(t)`` on each metric of a
    step is one blocking device→host copy per scalar.  The buffer PARKS
    the step's tensors (CUDA work is asynchronous: parking costs
    nothing) and materialises them in batches: ``host(step)`` flattens
    one step's tensors into one ``torch.cat`` and copies it to the host
    once; ``drain()`` does the same for every parked step in one call.
    A driver that only needs host values at log boundaries (the manual
    warmup switch) therefore syncs once per log window; the
    variance-ratio auto switch, which needs ``v_l1`` every step, pays
    one batched copy a step.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs.events import make_event


class NullSink:
    """The disabled sink: emit/flush/close are no-ops."""

    enabled = False
    path = None

    def emit(self, etype: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class TelemetrySink:
    """Buffered JSONL event writer (one validated event per line)."""

    enabled = True

    def __init__(self, directory: str, filename: str = "telemetry.jsonl",
                 buffer_lines: int = 64):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self.directory = directory
        self._buffer_lines = max(int(buffer_lines), 1)
        self._buf: List[str] = []
        self._file = open(self.path, "w")
        self.n_events = 0

    def emit(self, etype: str, **fields) -> None:
        """Validate + queue one event; flushes every ``buffer_lines``."""
        rec = make_event(etype, **fields)
        self._buf.append(json.dumps(rec))
        self.n_events += 1
        if len(self._buf) >= self._buffer_lines:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._file.write("\n".join(self._buf) + "\n")
            self._buf.clear()
            self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self.flush()
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def as_sink(directory: Optional[str], **kw):
    """``None`` -> the zero-cost :class:`NullSink`, else a
    :class:`TelemetrySink` writing ``<directory>/telemetry.jsonl``."""
    return NullSink() if directory is None else TelemetrySink(directory,
                                                              **kw)


def _fetch(records: List[dict]) -> List[Dict[str, object]]:
    """Host values of a list of ``{name: tensor}`` dicts: every tensor
    flattened to f32 and concatenated in ONE ``torch.cat``, copied to the
    host once.  0-dim tensors come back as floats, the others as flat
    lists of floats."""
    if not records:
        return []
    names, flat = [], []
    for rec in records:
        for k, v in rec.items():
            t = torch.as_tensor(v)
            names.append((k, t.dim(), t.numel()))
            flat.append(t.reshape(-1).to(torch.float32))
    # one device on every tensor of a step: the cat is the whole transfer
    host = torch.cat(flat).tolist()
    out, i, it = [], 0, iter(names)
    for rec in records:
        vals = {}
        for _ in rec:
            k, dim, n = next(it)
            vals[k] = host[i] if dim == 0 else host[i:i + n]
            i += n
        out.append(vals)
    return out


class MetricBuffer:
    """Park per-step device metric dicts; fetch host floats in batches.

    ``push`` never blocks; ``host(step)`` materialises one step with one
    batched copy; ``drain()`` materialises everything still parked in one
    copy and returns ``(step, {name: float})`` pairs in step order.
    0-dim metrics come back as plain floats, the others (the per-segment
    audit vectors of :mod:`repro_torch.obs.audit`) as flat lists of
    floats, so every drained record is JSON-ready for the event schema.
    """

    def __init__(self):
        self._pending: Dict[int, dict] = {}   # step -> {name: tensor}
        self._host: Dict[int, Dict[str, object]] = {}

    def push(self, step: int, metrics: dict) -> None:
        self._pending[int(step)] = dict(metrics)

    def host(self, step: int) -> Dict[str, object]:
        """Host values for ``step`` — one batched copy, cached."""
        step = int(step)
        if step not in self._host:
            self._host[step] = _fetch([self._pending.pop(step)])[0]
        return self._host[step]

    def drain(self) -> List[Tuple[int, Dict[str, object]]]:
        """Materialise every parked step (ONE copy over the whole batch)
        and hand back all records in step order, clearing the buffer."""
        if self._pending:
            steps = sorted(self._pending)
            fetched = _fetch([self._pending[s] for s in steps])
            self._host.update(zip(steps, fetched))
            self._pending.clear()
        out = sorted(self._host.items())
        self._host.clear()
        return out

    @property
    def n_pending(self) -> int:
        """Steps parked on the device, not yet transferred."""
        return len(self._pending)
