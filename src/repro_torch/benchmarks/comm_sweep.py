"""Calibrate the links: per-tier α/β and the per-collective launch
overhead from timed collectives, written as the JSON that
``repro_torch.plan.cost.ClusterSpec.from_measured`` loads.

The port of ``benchmarks/comm_sweep.py``.  It spawns one process a rank
(NCCL on the cards, one card a rank; gloo on the CPU) over the mesh
``--mesh`` (``N``: one pod of N; ``PxNx1``: P pods of N, the launcher's
grammar, ``repro_torch.launch.mesh``) and times, for every tier
of more than one rank (intra = the data axis, cross = the pod axis),

  * ``all_reduce``             t = ov + 2·⌈log2 n⌉·α + 2·S·(n-1)/n / β
  * ``reduce_scatter_tensor``  t = ov +   ⌈log2 n⌉·α +   S·(n-1)/n / β

over a geometric payload sweep, each the slowest rank's least mean over
windows of back-to-back calls.  Then it solves one least-squares system
for (ov, α_tier, 1/β_tier), each row weighted by its own time: the two
families' different latency coefficients separate the shared overhead
from α, where the timings follow them.
The rows are ``repro_torch.plan.cost.op_coeffs_kind``, the formulas
``op_time`` prices, so a spec built from the output reproduces its
samples by construction.  A one-pod mesh fits only ``intra``; a cross
link between machines cannot be measured on one machine.

  python -m repro_torch.benchmarks.comm_sweep --mesh 4 --json links.json
  python -m repro_torch.benchmarks.comm_sweep --device cpu --mesh 2x2x1 \\
      --sizes 4096,65536                       # the machinery over gloo
  >>> ClusterSpec.from_measured("links.json")
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

SIZES = tuple(1 << k for k in range(12, 27, 2))   # 4 KiB .. 64 MiB
REPS = 10
WINDOWS = 3
KINDS = ("AllReduce", "ReduceScatter")


def fit_cluster(samples: Sequence[dict]) -> Dict[str, object]:
    """Joint least-squares (op_overhead, α/β per tier) from timed samples
    ``{tier, op, n, nbytes, seconds}`` (``op`` a collective kind name),
    each row weighted by 1/seconds.  A non-positive coefficient is
    clamped to a tiny positive value and named in ``clamped``."""
    from repro_torch.plan.cost import op_coeffs_kind
    if not samples:
        raise ValueError("fit_cluster needs at least one timed sample")
    if any(s["n"] < 2 for s in samples):
        raise ValueError("a group of one rank moves no bytes: its alpha "
                         "and beta columns are zero")
    tiers = sorted({s["tier"] for s in samples})
    cols = 1 + 2 * len(tiers)
    rows, ts = [], []
    for s in samples:
        ov, al, ib = op_coeffs_kind(s["op"], s["n"], float(s["nbytes"]))
        row = [ov] + [0.0] * (cols - 1)
        j = 1 + 2 * tiers.index(s["tier"])
        row[j], row[j + 1] = al, ib
        rows.append(row)
        ts.append(float(s["seconds"]))
    ts = np.asarray(ts)
    if np.any(ts <= 0):
        raise ValueError("every timed sample needs a positive time")
    x, *_ = np.linalg.lstsq(np.asarray(rows) / ts[:, None],
                            np.ones_like(ts), rcond=None)
    clamped = ["op_overhead"] if x[0] <= 0 else []
    out: Dict[str, object] = {"op_overhead": float(max(x[0], 1e-9)),
                              "tiers": {}, "clamped": clamped}
    for i, tier in enumerate(tiers):
        alpha, inv_b = x[1 + 2 * i], x[2 + 2 * i]
        clamped += [f"{tier}.{name}" for name, v in
                    (("latency", alpha), ("bandwidth", inv_b)) if v <= 0]
        out["tiers"][tier] = {"latency": float(max(alpha, 1e-9)),
                              "bandwidth": 1.0 / float(max(inv_b, 1e-15))}
    return out


def _tiers(mesh):
    """tier -> mesh axes of every tier with more than one rank."""
    sizes = dict(zip(mesh.axes, mesh.sizes))
    if len(mesh.axes) == 1:
        return {"intra": mesh.axes} if mesh.n_dp > 1 else {}
    out = {}
    if sizes["data"] > 1:
        out["intra"] = ("data",)
    if sizes["pod"] > 1:
        out["cross"] = ("pod",)
    return out


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # reduce_scatter_single is the newer name of reduce_scatter_tensor
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def _timed(fn, dev: torch.device, group) -> float:
    """The slowest rank's least, over ``WINDOWS`` windows, of the mean
    seconds of ``REPS`` back-to-back calls (CUDA events on a card, the
    host clock on the CPU)."""
    fn()
    t = float("inf")
    for _ in range(WINDOWS):
        dist.barrier(group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            end.synchronize()
            t = min(t, start.elapsed_time(end) / 1e3 / REPS)
        else:
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            t = min(t, (time.perf_counter() - t0) / REPS)
    worst = torch.tensor([t], dtype=torch.float64, device=dev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return float(worst.item())


def sweep(mesh_spec: str, sizes: Sequence[int], dev: torch.device
          ) -> List[dict]:
    """Time both collective families on every tier of ``mesh_spec``
    (in an initialised process group spanning its ranks)."""
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.plan.executor import group_of
    mesh = build_mesh(mesh_spec)
    samples = []
    for tier, axes in _tiers(mesh).items():
        group = group_of(axes)
        n = dist.get_world_size(group)
        for nbytes in sizes:
            d = max(nbytes // 4, n)
            d -= d % n
            x = torch.ones(d, dtype=torch.float32, device=dev)
            chunk = torch.empty(d // n, dtype=torch.float32, device=dev)
            calls = {
                "AllReduce": lambda: dist.all_reduce(x, group=group),
                "ReduceScatter": lambda: _reduce_scatter(chunk, x, group)}
            for kind in KINDS:
                samples.append({"tier": tier, "op": kind, "n": int(n),
                                "nbytes": 4 * d,
                                "seconds": _timed(calls[kind], dev,
                                                  group)})
    return samples


def init_rank(rank: int, world: int, workdir: str,
              device: str) -> torch.device:
    """This spawned rank's device (card ``rank`` on cuda) and its process
    group (NCCL on cuda, gloo on cpu; a file rendezvous in ``workdir``)."""
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)      # the ranks share the host's cores
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    return dev


def _rank_main(rank: int, world: int, workdir: str, mesh_spec: str,
               sizes: Sequence[int], device: str) -> None:
    dev = init_rank(rank, world, workdir, device)
    try:
        samples = sweep(mesh_spec, sizes, dev)
        if rank == 0:
            with open(os.path.join(workdir, "samples.json"), "w") as f:
                json.dump(samples, f)
    finally:
        dist.destroy_process_group()


def spawn(main, world: int, device: str, *args) -> str:
    """Run ``main(rank, world, workdir, *args)`` in ``world`` spawned
    processes (one card each on cuda) and return their work directory."""
    from torch import multiprocessing as mp
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, "
                           f"{torch.cuda.device_count()} found")
    workdir = tempfile.mkdtemp(prefix="repro_torch_comm_")
    mp.start_processes(main, args=(world, workdir) + tuple(args),
                       nprocs=world, start_method="spawn")
    return workdir


def run(mesh_spec: str = "4", sizes: Sequence[int] = SIZES,
        device: str = "cuda", json_path: Optional[str] = None,
        verbose: bool = True) -> Dict[str, object]:
    """Spawn the mesh's ranks, sweep, fit, and write the
    ``ClusterSpec.from_measured`` JSON."""
    from repro_torch.launch.mesh import parse_mesh
    dp_sizes, tp = parse_mesh(mesh_spec)
    if tp != 1:
        raise ValueError(f"mesh {mesh_spec!r}: the sweep times the dp "
                         "links (a model axis of 1)")
    world = int(np.prod(dp_sizes))
    if world < 2:
        raise ValueError(f"mesh {mesh_spec!r} has one rank: nothing to "
                         "calibrate")
    workdir = spawn(_rank_main, world, device, mesh_spec, tuple(sizes),
                    device)
    try:
        with open(os.path.join(workdir, "samples.json")) as f:
            samples = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    fit = fit_cluster(samples)
    n_outer = dp_sizes[0] if len(dp_sizes) > 1 else 1
    tiers = fit["tiers"]
    out = {"name": f"measured-{device}",
           "card": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "intra": tiers.get("intra") or tiers.get("cross"),
           "cross": tiers.get("cross") if "intra" in tiers else None,
           "op_overhead": fit["op_overhead"], "clamped": fit["clamped"],
           "n_inner": int(dp_sizes[-1]), "n_outer": int(n_outer),
           "samples": samples}
    if verbose:
        print(f"== comm_sweep over {world} ranks ({device}, mesh "
              f"{mesh_spec}, {len(samples)} samples) ==")
        for tier in ("intra", "cross"):
            if out[tier]:
                print(f"  {tier:5s} alpha {out[tier]['latency'] * 1e6:10.3f}"
                      f" us  beta {out[tier]['bandwidth'] / 1e9:10.3f} GB/s")
        print(f"  op_overhead {out['op_overhead'] * 1e6:.3f} us")
        if out["cross"] is None:
            print("  one pod: only the intra link is fitted; "
                  "ClusterSpec.from_measured uses it for cross too")
        if fit["clamped"]:
            print(f"  fit clamped {fit['clamped']}: the timings do not "
                  "resolve these terms; ClusterSpec.from_measured refuses "
                  "this JSON")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
        if verbose:
            print(f"wrote {json_path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", default="4",
                    help="N (one pod of N ranks) or PxNx1 (P pods of N)")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated payload bytes (default "
                         "4 KiB .. 64 MiB)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None,
                    help="write the ClusterSpec.from_measured JSON here")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes \
        else SIZES
    run(args.mesh, sizes, args.device, json_path=args.json)


if __name__ == "__main__":
    main()
