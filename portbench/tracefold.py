"""Fold one rank's ``torch.profiler`` chrome trace of the traced steps
into what the per-layer readers read.

The join is Kineto's own: each device event (``kernel``, ``gpu_memcpy``,
``gpu_memset``) follows its ``args.correlation`` to the host launch
(``cuda_runtime`` / ``cuda_driver``), and the launch's host time places
it in the benchmark's ``portbench.step`` ranges: up to the end of the
step's last ``train.backward`` range (the program's span around each
backward pass) it belongs to the model, after it to the optimizer.
``portbench.traced`` brackets the traced steps and the final device
sync: it is the traced window.

The fold keeps, per rank: every kernel with its part, class and device
seconds; the device's busy seconds (the union of the device events'
intervals inside the window); the idle gaps between them, named by the
innermost host range open on the launching thread when each gap began;
the device time by operation name; and, for each launch spy, the matched
device seconds of each recorded call (the i-th call of a wrapper is the
i-th of its kernels in launch order).
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

from portbench import classify

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
STEP_RANGE = "portbench.step"
WINDOW_RANGE = "portbench.traced"
BACKWARD_RANGE = "train.backward"
TOP = 10


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    return [e for e in events if isinstance(e, dict)
            and e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(host: List[dict], times: List[float]) -> List[Optional[str]]:
    """The innermost host range (``host`` sorted by start, nested) open at
    each of the sorted ``times``."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(host) and host[j]["ts"] <= t:
            e = host[j]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(str(stack[-1]["name"])[:120] if stack else None)
    return out


def fold(events: List[dict], spies: Dict[str, Tuple[str, List[dict]]]
         ) -> dict:
    """The per-rank summary; ``spies`` maps a spy's name to (the device
    kernel's name fragment, the recorded calls in order)."""
    us = 1e-6
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_RANGE]
    if not windows:
        raise ValueError("the trace holds no traced window range")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == STEP_RANGE)
    bwd_ends = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e.get("name") == BACKWARD_RANGE)
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = e
    step_starts = [a for a, _ in steps]

    def part_of(t: float) -> Optional[str]:
        i = bisect.bisect_right(step_starts, t) - 1
        if i < 0 or t > steps[i][1]:
            return None
        a, b = steps[i]
        ends = [x for x in bwd_ends if a <= x <= b]
        return "model" if ends and t <= ends[-1] else "optimizer"

    kernels, intervals, by_name = [], [], {}
    next_launch = []           # (device start, launch event) for the gaps
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur <= w0 or ts >= w1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        name = str(e.get("name", ""))
        intervals.append((max(ts, w0), min(ts + dur, w1)))
        by_name[name] = by_name.get(name, 0.0) + dur * us
        if launch is not None:
            next_launch.append((ts, launch))
        if e.get("cat") != "kernel":
            continue
        part = part_of(float(launch["ts"])) if launch is not None else None
        kernels.append({"name": name, "part": part, "s": dur * us,
                        "corr": corr if corr is not None else -1,
                        "nccl": classify.is_nccl(name),
                        "gemm": classify.is_gemm(name)})
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) * us
    # the idle gaps, each named by the host range open on the thread that
    # launches the kernel that ends it, when the gap began
    starts = sorted(next_launch, key=lambda p: p[0])
    start_ts = [s for s, _ in starts]
    gaps = []
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        i = bisect.bisect_left(start_ts, b0)
        if i < len(starts):
            gaps.append((a1, b0 - a1, starts[i][1]))
    by_thread: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") in HOST_CATS:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    gap_names: Dict[str, float] = {}
    grouped: Dict[Tuple, List[Tuple[float, float]]] = {}
    for t, length, launch in gaps:
        grouped.setdefault((launch.get("pid"), launch.get("tid")),
                           []).append((t, length))
    for key, items in grouped.items():
        items.sort()
        names = _innermost(by_thread.get(key, []), [t for t, _ in items])
        for (t, length), name in zip(items, names):
            name = name or "(no host range)"
            gap_names[name] = gap_names.get(name, 0.0) + length * us
    launched = {}
    for spy, (fragment, calls) in spies.items():
        ks = sorted((k for k in kernels if fragment in k["name"]),
                    key=lambda k: k["corr"])
        launched[spy] = [[c, k["s"]] for c, k in zip(calls, ks)] \
            if len(ks) == len(calls) else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"steps": len(steps), "window_s": (w1 - w0) * us,
            "busy_s": busy_s, "kernels": [
                {k: v for k, v in kk.items() if k != "corr"}
                for kk in kernels],
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in gap_names.items()),
                                key=lambda p: -p[1])[:TOP],
            "launches": launched}
