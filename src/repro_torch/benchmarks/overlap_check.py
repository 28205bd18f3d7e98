"""Benchmark: verify the pipelined overlap is REAL on the device — the
collective kernels of one pipelined exchange must run while other kernels
run on another stream.

The port of ``benchmarks/overlap_check.py``.  The reference parses the
compiled, scheduled HLO for async ``-start``/``-done`` pairs with work
scheduled between them.  Its analogue here is the device timeline: each
rank traces ONE pipelined exchange (``compressed_exchange`` with
``n_buckets`` buckets: hier on a 2-axis mesh, flat otherwise) with
``torch.profiler``; for every NCCL kernel in the trace the check asks,
through ``obs.profile.overlap_audit``, how much of it a kernel on another
stream (the next bucket's compress and decompress on the compute stream)
covers.  At least one NCCL kernel must be overlapped.

``--bwd`` checks the BACKWARD overlap instead (the reference's
``check_bwd_overlap``): the compressed exchange must start while the
backward pass still runs.  :func:`build_bwd_exchange` is the reference's
micro, a chain of ``tanh(h @ w)`` layers whose buckets are fed to the
pipelined exchange from gradient hooks as their layers' gradients land,
as ``train.step`` feeds them; :func:`check_bwd_trace` reads one rank's
trace of it (or of ``launch.train --overlap-bwd on --profile``): an NCCL
kernel counts when at least one matmul kernel of the same backward pass
was issued before it and one after, in host issue order (the analogue
of the scheduled HLO's order), and its device time under those matmuls
is reported beside.

Backends with no collective kernel on a device stream SKIP with exit code
0, as the reference does without async pairs: one rank (no collective at
all), and gloo on the CPU (its collectives run on host threads).  The
check is meaningful over NCCL on a multi-card mesh:

  python -m repro_torch.benchmarks.overlap_check --mesh 2x2 \\
      --buckets 2 --trace-dir /tmp/overlap_trace
  python -m repro_torch.benchmarks.overlap_check --bwd --mesh 4
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.benchmarks.comm_sweep import init_rank, spawn
from repro_torch.obs.profile import (LAUNCH_CATS, load_trace_events,
                                     overlap_audit)
from repro_torch.obs.trace import BACKWARD_SPAN

_NCCL = re.compile(r"nccl", re.IGNORECASE)
# the collective of an NCCL kernel, from its name (all_to_all runs as
# grouped send/recv)
_NCCL_KIND = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")
_KINDS = {"AllGather": "all-gather", "AllReduce": "all-reduce",
          "ReduceScatter": "reduce-scatter", "SendRecv": "all-to-all",
          "Broadcast": "broadcast", "Reduce": "reduce"}
# a kernel is a "dot" when the innermost CPU op around its launch is one
# of these (a matmul or a convolution), found through its correlation id:
# never by kernel name (cuBLAS names them nvjet_*, sm90_xmma_*, cutlass_*)
DOT_OPS = frozenset((
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm",
    "aten::matmul", "aten::linear", "aten::_scaled_mm", "aten::convolution",
    "aten::_convolution", "aten::convolution_backward",
    "aten::cudnn_convolution", "aten::cudnn_convolution_transpose"))


def _traced_exchange(mesh_shape: Sequence[int], d: int, block: int,
                     n_buckets: int, dev: torch.device, rank: int,
                     path: str) -> None:
    """Run the exchange once (NCCL's connections), then once more under
    the profiler; write that trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import comm
    from repro_torch.launch.mesh import build_mesh, pod_split
    from repro_torch.optim import get_compressor
    mesh = build_mesh(tuple(mesh_shape) + (1,))
    inner, outer, _, _ = pod_split(mesh.axes, mesh.sizes) \
        if mesh.n_dp > 1 else ((), (), 1, 1)
    comp = get_compressor("onebit", block_size=block)
    plan, _ = comm.exchange_plan(d, {}, inner, outer, comp)
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(d, generator=gen).to(dev)

    def exchange():
        errs = {op.err_slot: torch.zeros(op.d_in, device=dev)
                for op in plan.ops if op.err_slot is not None}
        comm.compressed_exchange(x, errs, inner, outer, comp,
                                 n_buckets=n_buckets)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    exchange()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        exchange()
    prof.export_chrome_trace(path)


def _rank_main(rank: int, world: int, workdir: str, mesh_shape, d: int,
               block: int, n_buckets: int, device: str) -> None:
    dev = init_rank(rank, world, workdir, device)
    try:
        _traced_exchange(mesh_shape, d, block, n_buckets, dev, rank,
                         os.path.join(workdir, f"trace_rank{rank}.json"))
    finally:
        dist.destroy_process_group()


def check_trace_overlap(events: Sequence[dict]) -> Dict[str, object]:
    """Scan one rank's trace for NCCL kernels that a kernel on another
    stream overlaps.  Any kernel counts as work, as any instruction
    between an async start and done does in the reference (another
    collective too); each NCCL kernel's time under compute kernels and
    under other NCCL kernels is also reported apart.  Returns
    ``{collectives, overlapped, overlapped_compute, overlapped_nccl,
    overlap_efficiency, details}``; ``collectives == 0`` means no
    collective kernel ran on a device stream (nothing to check)."""
    us = 1e-6
    kernels = [{"name": str(e.get("name", "")),
                "stream": (e.get("args") or {}).get("stream", e.get("tid")),
                "t_start": e["ts"] * us, "t_end": (e["ts"] + e["dur"]) * us}
               for e in events if e.get("cat") == "kernel"]
    wire = [k for k in kernels if _NCCL.search(k["name"])]

    def hidden_under(k, others):
        audit = overlap_audit([dict(k, stream="wire")] + [
            dict(o, stream="other") for o in others])
        return audit["streams"]["wire"]["hidden"]

    details = []
    for k in wire:
        others = [o for o in kernels if o["stream"] != k["stream"]]
        hidden = {
            "any": hidden_under(k, others),
            "compute": hidden_under(k, [o for o in others
                                        if not _NCCL.search(o["name"])]),
            "nccl": hidden_under(k, [o for o in others
                                     if _NCCL.search(o["name"])])}
        details.append({"kernel": k["name"][:48], "stream": k["stream"],
                        "us": (k["t_end"] - k["t_start"]) / us,
                        "hidden_us": hidden["any"] / us,
                        "hidden_compute_us": hidden["compute"] / us,
                        "hidden_nccl_us": hidden["nccl"] / us,
                        "overlapped": hidden["any"] > 0})
    whole = overlap_audit([dict(k, stream="nccl" if _NCCL.search(k["name"])
                                else f"s{k['stream']}") for k in kernels])
    return {"collectives": len(wire),
            "overlapped": sum(x["overlapped"] for x in details),
            "overlapped_compute": sum(x["hidden_compute_us"] > 0
                                      for x in details),
            "overlapped_nccl": sum(x["hidden_nccl_us"] > 0 for x in details),
            "overlap_efficiency": whole["overlap_efficiency"],
            "kernels": len(kernels), "details": details}


# --------------------------------------------------------------------------
# --bwd: the exchange under the backward pass
# --------------------------------------------------------------------------

def _innermost_ops(events: Sequence[dict], queries: Sequence[tuple]
                   ) -> List[Optional[dict]]:
    """For each ``(pid, tid, ts)`` query, the innermost ``cpu_op`` on that
    thread open at ``ts`` (None outside every op): one sweep a thread."""
    ops: Dict[tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: List[Optional[dict]] = [None] * len(queries)
    by_thread: Dict[tuple, List[int]] = {}
    for i, (pid, tid, _) in enumerate(queries):
        by_thread.setdefault((pid, tid), []).append(i)
    for key, idx in by_thread.items():
        rows = sorted(ops.get(key, ()),
                      key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[dict] = []
        j = 0
        for i in sorted(idx, key=lambda i: queries[i][2]):
            t = queries[i][2]
            while j < len(rows) and float(rows[j]["ts"]) <= t:
                e = rows[j]
                while stack and _end(stack[-1]) < float(e["ts"]):
                    stack.pop()
                stack.append(e)
                j += 1
            while stack and _end(stack[-1]) < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
    return out


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e["dur"])


def _issues(events: Sequence[dict], kernels: Sequence[dict]):
    """Each kernel's host issue: ``(pid, tid, ts)`` of its launch (the
    ``cuda_runtime`` / ``cuda_driver`` event of the same correlation id),
    else of the ``cpu_op`` of the same ``External id`` (the c10d op of a
    collective whose launch the trace lacks), else None."""
    launches, by_ext = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e
        elif e.get("cat") == "cpu_op" and "External id" in args:
            by_ext.setdefault(args["External id"], e)
    out = []
    for k in kernels:
        args = k.get("args") or {}
        e = launches.get(args.get("correlation")) or \
            by_ext.get(args.get("External id"))
        out.append(None if e is None else
                   (e.get("pid"), e.get("tid"), float(e["ts"])))
    return out


def check_bwd_trace(events: Sequence[dict]) -> Dict[str, object]:
    """Scan one rank's trace for NCCL kernels issued BETWEEN matmul
    kernels of a backward pass: the counterpart of the reference's
    ``check_bwd_overlap`` on the device timeline.

    A dot is a kernel whose launch sits innermost in a :data:`DOT_OPS`
    CPU op (joined through the Kineto correlation id, on whichever
    thread launched it: backward's matmuls come from the autograd
    engine's).  The trace's backward passes are its ``train.backward``
    ranges (``obs.trace.BACKWARD_SPAN``; the whole trace when it has
    none).  An NCCL kernel counts when at least one dot of the backward
    pass it was issued in was issued before it and one after.  Each
    ``details`` entry (one an NCCL kernel, in device order) carries the
    reference's ``kind`` (from the kernel's name), ``index`` (its
    position among all kernels on the device timeline), ``dots_after``
    and ``overlapped_bwd``, and beside them its ``stream`` (each process
    group's collectives run on that group's own NCCL stream: the dp
    exchange's are told from a model group's by stream, not by name),
    its device ``us``, the part of it under dot kernels on another stream
    (``under_dots_us``) and ``device_dots_after``, the dots of its
    backward pass that start on the device after it starts.  Returns
    ``{pairs, overlapped_bwd, n_dots, details, ...}``; ``pairs == 0``
    means no collective kernel ran on a device stream."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: float(e["ts"]))
    issues = _issues(events, kernels)
    ops = _innermost_ops(events, [q or (None, None, 0.0) for q in issues])
    is_dot = [q is not None and op is not None and op.get("name") in DOT_OPS
              for q, op in zip(issues, ops)]
    windows = sorted((float(e["ts"]), _end(e)) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name") == BACKWARD_SPAN)
    n_passes = len(windows)
    if not windows:
        windows = [(-math.inf, math.inf)]
    starts = [w[0] for w in windows]

    def window_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= windows[i][1] else None

    dot_win = {i: window_of(issues[i][2]) for i in range(len(kernels))
               if is_dot[i]}
    dots = [i for i, w in dot_win.items() if w is not None]

    def iv(k, stream):
        return {"stream": stream, "t_start": float(k["ts"]),
                "t_end": _end(k)}

    details = []
    for i, k in enumerate(kernels):
        name = str(k.get("name", ""))
        if not _NCCL.search(name):
            continue
        m = _NCCL_KIND.search(name)
        stream = (k.get("args") or {}).get("stream", k.get("tid"))
        t = None if issues[i] is None else issues[i][2]
        w = None if t is None else window_of(t)
        mine = [j for j in dots if dot_win[j] == w] if w is not None \
            else []
        before = sum(1 for j in mine if issues[j][2] < t)
        after = len(mine) - before
        other = [kernels[j] for j in mine
                 if (kernels[j].get("args") or {}).get(
                     "stream", kernels[j].get("tid")) != stream]
        under = overlap_audit([iv(k, "wire")] + [iv(o, "dots")
                                                 for o in other])
        details.append({
            "kind": _KINDS.get(m.group(1), m.group(1).lower())
            if m else "nccl",
            "index": i, "kernel": name[:48], "stream": stream,
            "issued": t is not None, "in_backward": w is not None,
            "dots_before": before, "dots_after": after,
            "overlapped_bwd": before > 0 and after > 0,
            "us": float(k["dur"]),
            "under_dots_us": under["streams"]["wire"]["hidden"],
            "device_dots_after": sum(1 for j in mine
                                     if float(kernels[j]["ts"])
                                     > float(k["ts"]))})
    streams: Dict[str, int] = {}
    for x in details:
        streams[str(x["stream"])] = streams.get(str(x["stream"]), 0) + 1
    return {"pairs": len(details),
            "overlapped_bwd": sum(x["overlapped_bwd"] for x in details),
            "n_dots": len(dots), "details": details,
            "backward_passes": n_passes,
            "issued": sum(x["issued"] for x in details),
            "nccl_us": sum(x["us"] for x in details),
            "nccl_under_dots_us": sum(x["under_dots_us"] for x in details),
            "device_overlapped": sum(x["under_dots_us"] > 0
                                     for x in details),
            "streams": streams}


def micro_inputs(n: int, n_layers: int = 4, width: int = 64,
                 seed: int = 0):
    """(ws, x) of the micro as numpy: ``n_layers`` weights N(0, 1)/width
    and x (n, 8, width) N(0, 1), from ``seed`` (the reference draws them
    from its own PRNG keys; a test passes those)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((width, width)) / width).astype(np.float32)
          for _ in range(n_layers)]
    x = rng.standard_normal((n, 8, width)).astype(np.float32)
    return ws, x


def _chain_loss(ws: Sequence[torch.Tensor], h: torch.Tensor
                ) -> torch.Tensor:
    for w in ws:
        h = torch.tanh(h @ w)
    return (h * h).sum()


def build_bwd_exchange(mesh_shape: Sequence[int], block: int,
                       n_buckets: int, n_layers: int = 4, width: int = 64,
                       *, ws=None, x=None, grads=None, comp=None,
                       device: str = "cuda"):
    """One backward pass of the micro feeding the pipelined exchange on
    this rank; returns ``(out, worker_err, server_err)``.

    The weights are views of one flat ``(d_pad,)`` vector and their
    gradients views of another (``d_pad`` padded to n * ``block``), as
    in ``train.step``.  The buckets are ``Bucketer.for_exchange(d_pad,
    n, block, n_buckets)``'s, in the ``Wavefront`` of
    ``core.comm.start_exchange`` (flat, over every rank of
    ``mesh_shape``); a gradient hook on each weight feeds, and issues,
    every bucket whose weights have all landed, so the last layers'
    bucket goes on the wire while the first layers' matmuls still run.
    The loss is ``sum(h * h)`` of the ``tanh(h @ w)`` chain on this
    rank's ``x[rank]``, its backward inside a ``train.backward`` range.
    ``ws`` / ``x``: numpy inputs (default :func:`micro_inputs`);
    ``grads``: per-weight gradients to land instead of a backward pass
    (in backward order, through the same hooks' code); ``comp``: the
    compressor (default 1-bit at ``block``).  The process group, if
    any, holds exactly the mesh's ranks."""
    from repro_torch.core import comm
    from repro_torch.core.compression import padded_length
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim import get_compressor
    n = math.prod(mesh_shape)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no card; pass "
                               "device='cpu'")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    build_mesh((n,))
    axes = ("dp",) if n > 1 else ()
    rank = comm.axis_index(axes)
    if ws is None or x is None:
        ws0, x0 = micro_inputs(n, n_layers, width)
        ws = ws0 if ws is None else ws
        x = x0 if x is None else x
    comp = comp or get_compressor("onebit", block_size=block)
    shapes = [tuple(np.shape(w)) for w in ws]
    sizes = [math.prod(sh) for sh in shapes]
    d_pad = padded_length(sum(sizes), n, block)
    flat = torch.zeros(d_pad, device=dev)
    g = torch.zeros(d_pad, device=dev)
    params, lo = [], 0
    for w, sh, sz in zip(ws, shapes, sizes):
        flat[lo:lo + sz].copy_(torch.from_numpy(
            np.array(w, dtype=np.float32)).reshape(-1))
        p = torch.nn.Parameter(flat[lo:lo + sz].view(sh))
        p.grad = g[lo:lo + sz].view(sh)
        params.append((p, lo, lo + sz))
        lo += sz
    errs = {"worker": torch.zeros(d_pad, device=dev),
            "server": torch.zeros(d_pad // n, device=dev)}
    wf = comm.start_exchange(d_pad, errs, axes, (), comp, n_buckets)
    if wf is None:                 # one bucket: the serial exchange
        _land_all(params, grads, x, rank, dev)
        out, errs = comm.compressed_exchange(g, errs, axes, (), comp)
        return out, errs["worker"], errs["server"]
    buckets = wf.pplan.buckets
    waiting = [sum(1 for _, a, b in params
                   if bp.offset < b and a < bp.offset + bp.size)
               for bp in buckets]

    def feed_ready():
        for bi, bp in enumerate(buckets):
            if not waiting[bi] and not wf.fed(bi):
                wf.feed(bi, g[bp.offset:bp.offset + bp.size])
        wf.issue_ready()

    def fired(a, b, _param):
        for bi, bp in enumerate(buckets):
            if bp.offset < b and a < bp.offset + bp.size:
                waiting[bi] -= 1
        feed_ready()

    handles = [p.register_post_accumulate_grad_hook(
        lambda prm, a=a, b=b: fired(a, b, prm)) for p, a, b in params]
    try:
        feed_ready()               # a bucket of padding alone
        _land_all(params, grads, x, rank, dev, on_landed=fired)
    finally:
        for h in handles:
            h.remove()
    out, errs = wf.finish()
    return out, errs["worker"], errs["server"]


def _land_all(params, grads, x, rank: int, dev, on_landed=None) -> None:
    """The micro's backward pass into the gradient views, or, with
    ``grads``, those gradients landed in backward order (last weight
    first) through ``on_landed``."""
    if grads is None:
        h = torch.from_numpy(np.array(x[rank], dtype=np.float32)).to(dev)
        loss = _chain_loss([p for p, _, _ in params], h)
        with record_function(BACKWARD_SPAN):
            loss.backward()
        return
    with torch.no_grad():
        for (p, a, b), gr in reversed(list(zip(params, grads))):
            p.grad.copy_(torch.from_numpy(
                np.array(gr, dtype=np.float32)).reshape(p.shape))
            if on_landed is not None:
                on_landed(a, b, p)


def _bwd_traced(mesh_shape, block: int, n_buckets: int, device: str,
                path: str) -> None:
    """The micro once (NCCL's connections), then once under the
    profiler; write that trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    def once():
        build_bwd_exchange(mesh_shape, block, n_buckets, device=device)
        if device == "cuda":
            torch.cuda.synchronize()

    once()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        once()
    prof.export_chrome_trace(path)


def _bwd_rank_main(rank: int, world: int, workdir: str, mesh_shape,
                   block: int, n_buckets: int, device: str) -> None:
    init_rank(rank, world, workdir, device)
    try:
        _bwd_traced(mesh_shape, block, n_buckets, device,
                    os.path.join(workdir, f"trace_rank{rank}.json"))
    finally:
        dist.destroy_process_group()


def run_bwd(mesh_shape: Optional[Sequence[int]] = None, block: int = 512,
            n_buckets: int = 2, trace_dir: Optional[str] = None,
            verbose: bool = True, device: str = "cuda"
            ) -> Dict[str, object]:
    """``--bwd``: trace the micro on every rank of a flat mesh (default:
    one rank a card, each a spawned process) after a warm call, and
    check each trace with
    :func:`check_bwd_trace`; raises when NCCL kernels ran but none was
    issued between backward matmuls."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("overlap_check --bwd on cuda needs a card; pass "
                           "device='cpu' for the gloo path")
    if mesh_shape is None:
        mesh_shape = (torch.cuda.device_count() if device == "cuda"
                      else 1,)
    mesh_shape = tuple(mesh_shape)
    world = math.prod(mesh_shape)
    # every rank traces in a fresh process, one rank too: a second
    # torch.profiler session in one process can read no device events
    workdir = spawn(_bwd_rank_main, world, device, mesh_shape, block,
                    n_buckets, device)
    try:
        ranks = [check_bwd_trace(load_trace_events(
            os.path.join(workdir, f"trace_rank{r}.json")))
            for r in range(world)]
        if trace_dir:
            shutil.copytree(workdir, trace_dir, dirs_exist_ok=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result = {k: sum(r[k] for r in ranks)
              for k in ("pairs", "overlapped_bwd", "n_dots", "issued",
                        "nccl_us", "nccl_under_dots_us",
                        "device_overlapped")}
    result.update(
        ranks=[{k: v for k, v in r.items() if k != "details"}
               for r in ranks],
        details=[dict(x, rank=i) for i, r in enumerate(ranks)
                 for x in r["details"]],
        mesh=list(mesh_shape), n_buckets=n_buckets, block=block,
        device=(torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu"))
    if verbose:
        print("== overlap_check --bwd (exchange under backward) ==")
        if result["pairs"] == 0:
            why = "one rank: no collective" if world == 1 else \
                f"{device} runs no collective kernel on a device stream"
            print(f"  [SKIP] {why} (mesh {result['mesh']}) — run over NCCL "
                  "on a multi-card mesh to verify backward overlap")
        else:
            for x in result["details"]:
                mark = "PASS" if x["overlapped_bwd"] else "FAIL"
                print(f"  [{mark}] rank {x['rank']} {x['kind']} at "
                      f"{x['index']} with {x['dots_after']} matmul "
                      f"kernel(s) still issued after it "
                      f"({result['ranks'][x['rank']]['n_dots']} total); "
                      f"{x['us']:.1f} us on the device, "
                      f"{x['under_dots_us']:.1f} us under matmuls")
    if result["pairs"] > 0 and result["overlapped_bwd"] == 0:
        raise AssertionError(
            "NCCL kernels found but NONE was issued between matmuls of "
            "the backward pass — the exchange is not hiding under "
            "backward: " + json.dumps(result["ranks"]))
    return result


def default_mesh(device: str) -> tuple:
    """Every card (one rank on the CPU), split 2 x n/2 when >= 4."""
    n = torch.cuda.device_count() if device == "cuda" else 1
    return (2, n // 2) if n >= 4 else (n,)


def run(mesh_shape: Optional[Sequence[int]] = None, d: Optional[int] = None,
        block: int = 512, n_buckets: int = 2,
        trace_dir: Optional[str] = None, verbose: bool = True,
        device: str = "cuda") -> Dict[str, object]:
    """Trace the exchange on every rank of the mesh (spawned, one card
    each; one rank runs in this process) and check each trace."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("overlap_check on cuda needs a card; pass "
                           "device='cpu' for the gloo path")
    mesh_shape = tuple(mesh_shape or default_mesh(device))
    world = 1
    for s in mesh_shape:
        world *= s
    if d is None:
        d = world * block * 2 * n_buckets
    if world == 1:
        workdir = tempfile.mkdtemp(prefix="repro_torch_overlap_")
        try:
            _traced_exchange(mesh_shape, d, block, n_buckets,
                             torch.device(device), 0,
                             os.path.join(workdir, "trace_rank0.json"))
        except BaseException:
            shutil.rmtree(workdir, ignore_errors=True)
            raise
    else:
        workdir = spawn(_rank_main, world, device, mesh_shape, d, block,
                        n_buckets, device)
    try:
        ranks = [check_trace_overlap(load_trace_events(
            os.path.join(workdir, f"trace_rank{r}.json")))
            for r in range(world)]
        if trace_dir:
            shutil.copytree(workdir, trace_dir, dirs_exist_ok=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result = {k: sum(r[k] for r in ranks)
              for k in ("collectives", "overlapped", "overlapped_compute",
                        "overlapped_nccl")}
    result.update(
        kernels=sum(r["kernels"] for r in ranks),
        ranks=[{k: v for k, v in r.items() if k != "details"}
               for r in ranks],
        details=[dict(x, rank=i) for i, r in enumerate(ranks)
                 for x in r["details"]],
        mesh=list(mesh_shape), n_buckets=n_buckets, d=d,
        device=(torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu"))
    if verbose:
        print("== overlap_check (collective kernels under other streams) "
              "==")
        if result["collectives"] == 0:
            why = "one rank: no collective" if world == 1 else \
                f"{device} runs no collective kernel on a device stream"
            print(f"  [SKIP] {why} (mesh {result['mesh']}) — run over NCCL "
                  "on a multi-card mesh to verify overlap")
        else:
            for x in result["details"]:
                mark = "PASS" if x["overlapped"] else "FAIL"
                print(f"  [{mark}] rank {x['rank']} {x['kernel']} "
                      f"{x['us']:.1f} us, {x['hidden_us']:.1f} us under "
                      f"another stream ({x['hidden_compute_us']:.1f} under "
                      f"compute, {x['hidden_nccl_us']:.1f} under NCCL)")
            print(f"  {result['overlapped']} of {result['collectives']} "
                  f"NCCL kernels under another stream: "
                  f"{result['overlapped_compute']} under compute, "
                  f"{result['overlapped_nccl']} under NCCL")
    if result["collectives"] > 0 and result["overlapped"] == 0:
        raise AssertionError(
            "NCCL kernels found but NONE overlaps a kernel on another "
            "stream — the pipelined overlap is not real on this device: "
            + json.dumps(result["ranks"]))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", default=None,
                    help="dp mesh, e.g. 4 or 2x2 (pod x data); default: "
                         "every card, split 2 x n/2 when >= 4")
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--buckets", type=int, default=2)
    ap.add_argument("--trace-dir", default=None,
                    help="keep every rank's chrome trace here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bwd", action="store_true",
                    help="check the BACKWARD overlap instead: NCCL kernels "
                         "must be issued between matmuls of the backward "
                         "pass (the exchange launched mid-backward); the "
                         "mesh is flat over its ranks")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else None
    if args.bwd:
        return run_bwd(shape and (math.prod(shape),), args.block,
                       args.buckets, args.trace_dir, device=args.device)
    return run(shape, args.d, args.block, args.buckets, args.trace_dir,
               device=args.device)


if __name__ == "__main__":
    main()
