"""Fold a ``torch.profiler`` (Kineto) trace back onto the plan grid.

The executors open a ``record_function`` range around each half of every
collective op, named on the
``obs::<plan>::[b<bucket>.]s<stage>::<Kind>~<tier>`` grid — the (bucket,
stage, stream) grid ``repro_torch.plan.cost.pipeline_breakdown`` prices.
This module closes the predict→measure loop: capture a chrome trace of N
steady-state steps (``launch.train --profile DIR``) and join its device
events onto that grid.  The port of ``repro/obs/profile.py``.

The reference joins XLA's device events to scopes through the compiled
HLO's ``op_name`` metadata.  The port's join is Kineto's own linkage
(:func:`fold_trace`):

  1. start from each device event (``cat`` ``kernel``, ``gpu_memcpy`` or
     ``gpu_memset``);
  2. follow its ``args.correlation`` to the ``cuda_runtime`` (or
     ``cuda_driver``) event that launched it;
  3. take the innermost ``user_annotation`` range around that launch, on
     the same thread, whose name :func:`parse_scope` accepts: that is the
     cell.  An NCCL kernel is launched inside its op's issue range, so it
     lands on its collective's cell.

A CPU trace has no device events: there its ``cpu_op`` events take their
place (an op's own range is its launch; an op nested in another counted
op of the same range does not count again), so the fold runs on the CPU
too.  A window that holds no device events is an error, never an
all-residual fold.

On top of the fold:

  * :func:`overlap_audit` — per-stream busy / hidden / exposed time from
    any interval list, measured OR predicted (``pipeline_breakdown``'s
    ``intervals`` feed it directly);
  * :func:`attribution` — the ``profile`` telemetry event's fields:
    s/step, comm fraction, overlap efficiency, roofline fraction, and an
    explicit *unattributed residual* — attributed + residual sums to the
    profile window by construction.

Everything here is stdlib-only (no torch import): a trace folds offline,
on a log dir copied off the machine that produced it.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# the span grammar of repro_torch.obs.trace.span_name: plan names may
# contain "/", "(", ")", "+" (e.g. "pipe(flat/onebit)x2"), so the plan
# segment is a non-greedy anything-up-to the next "::".  "~" is the tier
# separator; "@" is accepted as the reference's older logs spell it.
SCOPE_RE = re.compile(
    r"obs::(?P<plan>.+?)::(?:b(?P<bucket>\d+)\.)?s(?P<stage>\d+)"
    r"::(?P<kind>[A-Za-z]+)[~@](?P<tier>[a-z]+)")

# the device-event categories of a CUDA trace, and the host events that
# launch them (the join's correlation side)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# wire events: NCCL kernels on the card; the c10d / gloo calls of a CPU
# trace (the gloo work itself runs on gloo's own threads)
_WIRE_RE = re.compile(r"nccl|c10d::|gloo|record_param_comms",
                      re.IGNORECASE)

# the host-span name launch.train brackets the traced steps with
WINDOW_SPAN = "profile.window"


def parse_scope(name: str) -> Optional[Dict[str, object]]:
    """Parse the first ``obs::`` scope out of ``name`` (a range name or a
    span name); None when absent."""
    m = SCOPE_RE.search(name)
    if not m:
        return None
    b = m.group("bucket")
    return {"plan": m.group("plan"),
            "bucket": int(b) if b is not None else None,
            "stage": int(m.group("stage")),
            "kind": m.group("kind"), "tier": m.group("tier")}


def cell_key(scope: Dict[str, object]) -> Tuple:
    """The fold's grid key: (plan, bucket, stage, kind, tier)."""
    return (scope["plan"], scope["bucket"], scope["stage"],
            scope["kind"], scope["tier"])


# --------------------------------------------------------------------------
# chrome-trace loading
# --------------------------------------------------------------------------

def load_trace_events(path: str) -> List[dict]:
    """The complete-duration (``ph: "X"``) events of one chrome-trace
    JSON(.gz) file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X"
            and "ts" in e and "dur" in e]


def find_trace_files(profile_dir: str, rank: Optional[int] = None
                     ) -> List[str]:
    """The chrome-trace JSON(.gz) files under ``profile_dir``: the
    ``trace_rank<r>.json`` that ``launch.train --profile`` writes (only
    rank ``rank``'s when given), and any ``*.trace.json`` of a profiler's
    trace handler; sorted by name."""
    pats = ([f"trace_rank{rank}.json", f"trace_rank{rank}.json.gz"]
            if rank is not None else
            ["trace_rank*.json", "trace_rank*.json.gz", "*.trace.json",
             "*.trace.json.gz"])
    return sorted({f for pat in pats
                   for f in glob.glob(os.path.join(profile_dir, pat))})


def load_profile_dir(profile_dir: str, rank: Optional[int] = None
                     ) -> List[dict]:
    """Every trace event of :func:`find_trace_files`' files (rank
    ``rank``'s alone when given, as a per-rank check wants them)."""
    events: List[dict] = []
    for path in find_trace_files(profile_dir, rank):
        events += load_trace_events(path)
    return events


# --------------------------------------------------------------------------
# interval algebra (merged unions; everything in seconds)
# --------------------------------------------------------------------------

def merge_spans(spans: Iterable[Tuple[float, float]]
                ) -> List[Tuple[float, float]]:
    """Union of (start, end) intervals as a sorted disjoint list."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((s, e) for s, e in spans if e > s):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def span_length(merged: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def intersect_spans(a: Sequence[Tuple[float, float]],
                    b: Sequence[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Intersection of two merged disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def clip_spans(merged: Sequence[Tuple[float, float]], lo: float,
               hi: float) -> List[Tuple[float, float]]:
    return intersect_spans(merged, [(lo, hi)])


# --------------------------------------------------------------------------
# the fold: trace events -> measured grid timeline
# --------------------------------------------------------------------------

class _Annotations:
    """The ``obs::`` ``user_annotation`` ranges of one trace, per
    (pid, tid), for innermost-enclosing lookups."""

    def __init__(self, events: Sequence[dict]):
        self._by_thread: Dict[Tuple, List[Tuple[float, float, dict]]] = {}
        for e in events:
            if e.get("cat") != "user_annotation":
                continue
            scope = parse_scope(str(e.get("name", "")))
            if scope is None:
                continue
            key = (e.get("pid"), e.get("tid"))
            self._by_thread.setdefault(key, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), scope))
        self._starts = {}
        for key, rows in self._by_thread.items():
            rows.sort(key=lambda r: r[0])
            self._starts[key] = [r[0] for r in rows]

    def innermost(self, pid, tid, ts: float):
        """The innermost range on (pid, tid) holding ``ts`` (the
        latest-starting one that has not ended), as ``(t0, t1, scope)``;
        None outside every range."""
        rows = self._by_thread.get((pid, tid))
        if not rows:
            return None
        i = bisect.bisect_right(self._starts[(pid, tid)], ts)
        for row in reversed(rows[:i]):
            if row[0] <= ts <= row[1]:
                return row
        return None


def _cpu_op_events(events: Sequence[dict], ann: _Annotations
                   ) -> List[Tuple[dict, Optional[tuple]]]:
    """A CPU trace's stand-ins for device events, each with its innermost
    ``obs::`` range: the ``cpu_op`` events not nested in another counted
    ``cpu_op`` of the same range on their thread (an op nested in one
    that began outside its range — a collective issued from a backward
    hook — counts; its own sub-ops do not, so no time counts twice
    within a cell)."""
    by_thread: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for (pid, tid), rows in by_thread.items():
        rows.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[Tuple[float, Optional[tuple]]] = []
        for e in rows:
            t0 = float(e["ts"])
            while stack and stack[-1][0] <= t0:
                stack.pop()
            row = ann.innermost(pid, tid, t0)
            if stack and stack[-1][1] is row:
                continue
            stack.append((t0 + float(e["dur"]), row))
            out.append((e, row))
    return out


def fold_trace(events: Sequence[dict], device: str = "cuda",
               window: Optional[Tuple[float, float]] = None
               ) -> Dict[str, object]:
    """Join a trace's device events onto the plan grid (see the module
    docstring).  ``device`` says what the trace ran on: ``"cuda"`` folds
    the kernel / memcpy / memset events, ``"cpu"`` the ``cpu_op``
    events.

    Returns a fold dict:

      * ``cells`` — ``{(plan, bucket, stage, kind, tier): {n, t_wire,
        t_compute, t_total}}``: every device event attributed to its grid
        cell (NCCL / c10d events as wire, the rest as compute);
      * ``intervals`` — the matched events as ``{stream, phase, t_start,
        t_end, plan, bucket, stage, kind, tier}`` records (stream = the
        op's tier for wire events, ``"compute"`` otherwise), relative to
        the window's start — comparable to ``pipeline_breakdown``'s
        predicted ``intervals``;
      * ``t_window`` / ``window`` — the ``profile.window`` range when
        present (else the ``window`` argument, else the extent of the
        device events);
      * ``t_attributed`` / ``t_residual`` — union length of the matched
        intervals inside the window, and the rest: the two SUM TO
        ``t_window`` by construction;
      * ``n_events`` / ``n_matched`` / ``n_unattributed`` — device events
        in the window, and how many landed on a cell.

    Raises ``ValueError`` when the window holds no device event.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    us = 1e-6
    ann = _Annotations(events)
    if device == "cuda":
        launches = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[corr] = e
        dev_events = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            row = None if launch is None else ann.innermost(
                launch.get("pid"), launch.get("tid"), float(launch["ts"]))
            dev_events.append((e, row))
    else:
        dev_events = _cpu_op_events(events, ann)
    if window is None:
        for e in events:
            if e.get("cat") == "user_annotation" \
                    and str(e.get("name", "")) == WINDOW_SPAN:
                window = (e["ts"] * us, (e["ts"] + e["dur"]) * us)
                break
    if window is None and dev_events:
        window = (min(e["ts"] for e, _ in dev_events) * us,
                  max(e["ts"] + e["dur"] for e, _ in dev_events) * us)
    w0, w1 = window if window is not None else (0.0, 0.0)
    # device events inside the window
    dev_events = [(e, row) for e, row in dev_events
                  if e["ts"] * us < w1 and (e["ts"] + e["dur"]) * us > w0]
    if not dev_events:
        raise ValueError(
            f"no {'device' if device == 'cuda' else 'cpu_op'} events in "
            f"the profile window ({len(events)} trace events): nothing to "
            "fold")

    cells: Dict[Tuple, Dict[str, float]] = {}
    intervals: List[dict] = []
    matched_spans: List[Tuple[float, float]] = []
    n_matched = 0
    for e, row in dev_events:
        if row is None:
            continue
        scope = row[2]
        n_matched += 1
        t_start, t_end = e["ts"] * us, (e["ts"] + e["dur"]) * us
        wire = bool(_WIRE_RE.search(str(e.get("name", ""))))
        dur = t_end - t_start
        c = cells.setdefault(cell_key(scope), {
            "n": 0, "t_wire": 0.0, "t_compute": 0.0, "t_total": 0.0})
        c["n"] += 1
        c["t_wire" if wire else "t_compute"] += dur
        c["t_total"] += dur
        intervals.append({"stream": scope["tier"] if wire else "compute",
                          "phase": "wire" if wire else "compute",
                          "t_start": t_start - w0, "t_end": t_end - w0,
                          **scope})
        matched_spans.append((t_start, t_end))

    covered = clip_spans(merge_spans(matched_spans), w0, w1)
    t_window = w1 - w0
    t_attributed = span_length(covered)
    return {"window": (w0, w1), "t_window": t_window,
            "cells": cells, "intervals": intervals,
            "t_attributed": t_attributed,
            "t_residual": t_window - t_attributed,
            "n_events": len(dev_events), "n_matched": n_matched,
            "n_unattributed": len(dev_events) - n_matched}


def fold_profile(path: str, device: str = "cuda",
                 window: Optional[Tuple[float, float]] = None
                 ) -> Dict[str, object]:
    """End-to-end: load one chrome trace (``prof.export_chrome_trace``'s
    file, one rank's) and fold it."""
    return fold_trace(load_trace_events(path), device=device, window=window)


# --------------------------------------------------------------------------
# overlap audit: per-stream hidden vs exposed time
# --------------------------------------------------------------------------

def overlap_audit(intervals: Sequence[dict]) -> Dict[str, object]:
    """Per-stream busy / hidden / exposed seconds from an interval list
    (``{stream, t_start, t_end}`` records — a fold's measured intervals
    or ``pipeline_breakdown``'s predicted ones).

    ``busy`` is the union length of the stream's own intervals,
    ``hidden`` the part of it overlapped by ANY other stream, and
    ``exposed = busy - hidden`` — serialized time nothing else covers.
    ``overlap_efficiency`` aggregates the link streams — everything but
    ``compute`` and the ``bwd`` gradient-production stream (backward
    work is a thing comm hides UNDER, not comm to hide): hidden comm /
    busy comm, the fraction of wire time the schedule actually hid
    (1.0 when there is no comm to hide).
    """
    by_stream: Dict[str, List[Tuple[float, float]]] = {}
    for iv in intervals:
        by_stream.setdefault(str(iv["stream"]), []).append(
            (float(iv["t_start"]), float(iv["t_end"])))
    merged = {s: merge_spans(sp) for s, sp in by_stream.items()}
    streams: Dict[str, Dict[str, float]] = {}
    comm_busy = comm_hidden = 0.0
    for s, own in merged.items():
        others = merge_spans(
            [iv for o, sp in merged.items() if o != s for iv in sp])
        busy = span_length(own)
        hidden = span_length(intersect_spans(own, others))
        streams[s] = {"busy": busy, "hidden": hidden,
                      "exposed": busy - hidden}
        if s not in ("compute", "bwd"):
            comm_busy += busy
            comm_hidden += hidden
    return {"streams": streams, "comm_busy": comm_busy,
            "comm_hidden": comm_hidden,
            "comm_exposed": comm_busy - comm_hidden,
            "overlap_efficiency": (comm_hidden / comm_busy
                                   if comm_busy > 0 else 1.0)}


def audit_diff(measured: Dict[str, object],
               predicted: Dict[str, object]) -> List[dict]:
    """Side-by-side rows of two :func:`overlap_audit` results — the
    measured-vs-predicted overlap diff the report renders."""
    rows = []
    names = sorted(set(measured["streams"]) | set(predicted["streams"]))
    zero = {"busy": 0.0, "hidden": 0.0, "exposed": 0.0}
    for s in names:
        m = measured["streams"].get(s, zero)
        p = predicted["streams"].get(s, zero)
        rows.append({"stream": s,
                     "busy_measured": m["busy"],
                     "busy_predicted": p["busy"],
                     "hidden_measured": m["hidden"],
                     "hidden_predicted": p["hidden"],
                     "exposed_measured": m["exposed"],
                     "exposed_predicted": p["exposed"]})
    return rows


# --------------------------------------------------------------------------
# attribution report (the `profile` telemetry event's fields)
# --------------------------------------------------------------------------

def attribution(fold: Dict[str, object], n_steps: int,
                predicted: Optional[Dict[str, object]] = None,
                device=None, bytes_per_step: Optional[float] = None,
                source: Optional[str] = None) -> Dict[str, object]:
    """Fold + audit -> the flat field dict of one ``profile`` event
    (:mod:`repro_torch.obs.events`).

    ``predicted`` is a ``pipeline_breakdown`` result for the traced
    exchange: its ``intervals`` feed the predicted-side overlap audit
    and its compute-stream busy time gives ``roofline_fraction`` —
    predicted roofline seconds / measured compute seconds, how close the
    measured compute stream runs to ``device``'s roofline (the
    prediction is already rooflined on the run's DeviceSpec, so the
    ratio needs no further device math; <1 = slower than roofline).
    """
    audit = overlap_audit(fold["intervals"])
    t_window = float(fold["t_window"])
    out: Dict[str, object] = {
        "n_steps": int(n_steps),
        "t_window": t_window,
        "t_attributed": float(fold["t_attributed"]),
        "t_residual": float(fold["t_residual"]),
        "n_cells": len(fold["cells"]),
        "n_unattributed": int(fold["n_unattributed"]),
        "s_per_step": t_window / n_steps if n_steps > 0 else 0.0,
        "comm_fraction": (audit["comm_busy"] / t_window
                          if t_window > 0 else 0.0),
        "overlap_efficiency": audit["overlap_efficiency"],
        "exposed_comm_s": float(audit["comm_exposed"]),
        "streams": audit["streams"],
        "cells": [
            {"plan": k[0], "bucket": k[1], "stage": k[2], "kind": k[3],
             "tier": k[4], **{f: v for f, v in c.items()}}
            for k, c in sorted(fold["cells"].items(),
                               key=lambda kv: str(kv[0]))],
    }
    if predicted is not None:
        p_audit = overlap_audit(predicted.get("intervals", []))
        out["audit_vs_predicted"] = audit_diff(audit, p_audit)
        t_pred_compute = float(predicted.get("busy", {})
                               .get("compute", 0.0)) * max(n_steps, 1)
        t_meas_compute = audit["streams"].get(
            "compute", {}).get("busy", 0.0)
        if t_pred_compute > 0 and t_meas_compute > 0:
            out["roofline_fraction"] = t_pred_compute / t_meas_compute
    if bytes_per_step is not None:
        out["bytes_per_step"] = float(bytes_per_step)
    if source is not None:
        out["source"] = source
    return out
