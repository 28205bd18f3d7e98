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

Backends with no collective kernel on a device stream SKIP with exit code
0, as the reference does without async pairs: one rank (no collective at
all), and gloo on the CPU (its collectives run on host threads).  The
check is meaningful over NCCL on a multi-card mesh:

  python -m repro_torch.benchmarks.overlap_check --mesh 2x2 \\
      --buckets 2 --trace-dir /tmp/overlap_trace
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.benchmarks.comm_sweep import init_rank, spawn
from repro_torch.obs.profile import load_trace_events, overlap_audit

_NCCL = re.compile(r"nccl", re.IGNORECASE)


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
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else None
    return run(shape, args.d, args.block, args.buckets, args.trace_dir,
               device=args.device)


if __name__ == "__main__":
    main()
