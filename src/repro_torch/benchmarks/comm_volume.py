"""Benchmark: communication volume of the compressed exchange (paper
Fig. 3 / Sec. 6 / the "5x less end-to-end volume" claim), and the
plan-versus-wire byte gate (``--check-plans``).

The port of ``benchmarks/comm_volume.py``.  The reference counts
collective operand bytes in the compiled HLO; the port counts them at the
``torch.distributed`` call boundary (``analysis.roofline.ByteCounter``:
``all_to_all_single`` its input, ``all_gather_into_tensor`` /
``all_gather_single`` its gathered output, ``reduce_scatter_tensor`` its
input, ``all_reduce`` twice its buffer, the convention of
``AllReduce.hlo_bytes``), installed around each exchange and never by the
library.

``measured_volumes`` runs the exchange of a d = 2^20 vector as rank 0 of
8 flat (and 2 x 4 hier) ranks of torch's fake process group, on meta
tensors (``launch.dryrun.fake_world``): the wire format is the real one
of every registered compressor, so the reduction shows in the bytes the
collectives are handed, and nothing is computed or moved.  ``run`` prints
the Fig. 3 table from it (``wire_compression_x`` and the paper's
end-to-end volume ratios) and the hier schedule's cross-pod bytes from the
plans; ``cost_model_report`` the tuner's tables for three cluster
presets.

``--check-plans`` spawns 4 real ranks (NCCL on 4 cards, gloo on the CPU)
on a 2 x 2 (pod x data) mesh, runs each plan through the port's executors
on seeded inputs, and asserts that ``plan.hlo_bytes()`` — and
``PipelinedPlan.hlo_bytes()`` for the bucketed exchange — equals the
bytes counted on every rank, exactly:

  * flat over n = 4 (one exchange over both axes);
  * hier 2 x 2 (the two-level schedule, the outer EF slots for top-k);
  * both pipelined with 2 and 4 buckets.

Bucketing changes when bytes move, never how many.

  python -m repro_torch.benchmarks.comm_volume            # no card needed
  python -m repro_torch.benchmarks.comm_volume --check-plans
  python -m repro_torch.benchmarks.comm_volume --check-plans --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis.roofline import ByteCounter
from repro_torch.benchmarks.comm_sweep import init_rank, spawn

D = 1 << 20
BLOCK = 4096
MESH = "2x2x1"
N_INNER, N_OUTER = 2, 2
PIPE_BUCKETS = (2, 4)
# the volume measurement's meshes: flat over 8, hier 2 pods x 4
N_FLAT = 8
VOL_INNER, VOL_OUTER = 4, 2


def predicted_plans(d: int = D, block: int = BLOCK,
                    kinds: Optional[Sequence[str]] = None,
                    pipe_buckets: Sequence[int] = PIPE_BUCKETS) -> Dict:
    """The plans the exchange runs, built on the host: ``flat/<kind>``,
    ``hier/<kind>`` and their lowerings ``pipe<N>/<topology>/<kind>``."""
    from repro_torch.optim import get_compressor, list_compressors
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.plan import flat_schedule, hier_schedule, needs_outer_ef
    n = N_INNER * N_OUTER
    plans = {}
    for kind in (kinds or list_compressors()):
        comp = get_compressor(kind, block_size=block)
        serial = {
            "flat": flat_schedule(comp, d, n, ("pod", "data")),
            "hier": hier_schedule(comp, d, N_INNER, N_OUTER, ("data",),
                                  ("pod",), outer_ef=needs_outer_ef(comp))}
        for topo, plan in serial.items():
            plans[f"{topo}/{kind}"] = plan
            for nb in pipe_buckets:
                bk = Bucketer.for_exchange(d, n, block, nb)
                plans[f"pipe{nb}/{topo}/{kind}"] = lower_to_pipelined(
                    plan, comp, bk)
    return plans


def _errs(plan, dev) -> dict:
    """Zero EF slots of every slot the (serial) plan consumes."""
    return {op.err_slot: torch.zeros(op.d_in, device=dev)
            for op in plan.ops if op.err_slot is not None}


def _rank_main(rank: int, world: int, workdir: str, d: int, block: int,
               device: str) -> None:
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim import get_compressor
    from repro_torch.pipeline import PipelinedPlan, execute_pipelined
    from repro_torch.plan import execute_plan
    dev = init_rank(rank, world, workdir, device)
    try:
        build_mesh(MESH)
        plans = predicted_plans(d, block)
        gen = torch.Generator().manual_seed(rank)
        counts = {}
        for key, plan in plans.items():
            comp = get_compressor(key.split("/")[-1], block_size=block)
            x = torch.randn(d, generator=gen).to(dev)
            if isinstance(plan, PipelinedPlan):
                errs = _errs(plans[key.split("/", 1)[1]], dev)
                with ByteCounter() as c:
                    execute_pipelined(plan, comp, x, errs)
            else:
                with ByteCounter() as c:
                    execute_plan(plan, comp, x, _errs(plan, dev))
            counts[key] = c.bytes
        with open(os.path.join(workdir, f"counts{rank}.json"), "w") as f:
            json.dump(counts, f)
    finally:
        dist.destroy_process_group()


def check_plans(d: int = D, block: int = BLOCK, device: str = "cuda",
                verbose: bool = True) -> Dict[str, dict]:
    """Assert predicted plan bytes == counted bytes on every rank, for
    every registered compressor, serial and pipelined; returns the
    comparison table."""
    world = N_INNER * N_OUTER
    workdir = spawn(_rank_main, world, device, d, block, device)
    try:
        counts = []
        for r in range(world):
            with open(os.path.join(workdir, f"counts{r}.json")) as f:
                counts.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    table, failures = {}, []
    for key, plan in sorted(predicted_plans(d, block).items()):
        want = plan.hlo_bytes()
        got = [c[key] for c in counts]
        ok = all(g == want for g in got)
        table[key] = {"predicted": want, "counted": got, "match": ok}
        if not ok:
            failures.append(key)
        if verbose:
            print(f"  [{'PASS' if ok else 'FAIL'}] {key:22s} predicted "
                  f"{want:>12.0f}, counted {sorted(set(got))}")
    if failures:
        raise AssertionError(f"cost-model bytes differ from the bytes "
                             f"handed to torch.distributed for {failures}")
    return table


def run_check_plans(verbose: bool = True, device: str = "cuda"
                    ) -> Dict[str, dict]:
    """The harness's entry (``benchmarks.run``): ``check_plans`` at the
    default size."""
    if verbose:
        print(f"== comm_volume --check-plans: d={D}, block {BLOCK}, "
              f"{N_OUTER} x {N_INNER} ranks ({device}) ==")
    return check_plans(device=device, verbose=verbose)


# --------------------------------------------------------------------------
# the volume measurement (Fig. 3)
# --------------------------------------------------------------------------

def measured_volumes(d: int = D, n: int = N_FLAT, n_in: int = VOL_INNER,
                     n_out: int = VOL_OUTER, block: int = BLOCK, kinds=None,
                     topologies=("flat", "hier")) -> Dict[str, dict]:
    """Collective bytes a rank hands ``torch.distributed`` per (topology,
    compressor) for one exchange of a ``d``-vector, as the reference's
    ``measured_volumes``: ``{"<topo>/<kind>": {"bytes", "kinds"}}``, rank
    0 of a fake world of ``n`` flat or ``n_out x n_in`` hier ranks, on
    meta tensors."""
    from repro_torch.core.comm import compressed_exchange
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim import get_compressor, list_compressors
    from repro_torch.plan.schedules import needs_outer_ef
    meshes = {"flat": (str(n), ("dp",), ()),
              "hier": (f"{n_out}x{n_in}x1", ("data",), ("pod",))}
    out = {}
    for topo in topologies:
        spec, dp_axes, pod_axes = meshes[topo]
        world = n if topo == "flat" else n_in * n_out
        with fake_world(world):
            build_mesh(spec)
            for kind in (kinds or list_compressors()):
                comp = get_compressor(kind, block_size=block)
                errs = _meta_errs(d, topo, world, n_in, needs_outer_ef(comp))
                x = torch.empty(d, device="meta")
                with ByteCounter() as c:
                    compressed_exchange(x, errs, dp_axes, pod_axes, comp)
                out[f"{topo}/{kind}"] = {"bytes": c.bytes,
                                         "kinds": dict(c.by_kind)}
    return out


def _meta_errs(d: int, topo: str, world: int, n_in: int, outer: bool
               ) -> dict:
    """The exchange's EF slots on the meta device."""
    def meta(n):
        return torch.empty(n, device="meta")
    if topo == "flat":
        return {"worker": meta(d), "server": meta(d // world)}
    errs = {"worker": meta(d), "server": meta(d // n_in)}
    if outer:
        errs.update(outer=meta(d // n_in), outer_ag=meta(d // world))
    return errs


def endtoend_volume_ratio(warmup_ratio: float, compression: float = 32.0
                          ) -> float:
    """Paper Sec. 7.1: 1 / (w + (1-w)/16) for fp16; we report the fp32
    analogue with the measured wire compression."""
    return 1.0 / (warmup_ratio + (1.0 - warmup_ratio) / compression)


def run(verbose: bool = True) -> Dict[str, float]:
    """The reference's Fig. 3 table: each compressor's bytes a rank (flat,
    measured), its compression against the identity exchange and its
    analytic payload ratio, the paper's end-to-end volume ratios, and the
    hier schedule's cross-pod (DCI) bytes against flat, from the plans."""
    from repro_torch.optim import get_compressor, list_compressors
    from repro_torch.plan import (cross_pod_bytes, flat_schedule,
                                  get_cluster, hier_schedule,
                                  needs_outer_ef)
    d = D
    results: Dict[str, float] = {}
    vols = measured_volumes(topologies=("flat",))
    b_id = vols["flat/identity"]["bytes"]
    results["uncompressed_bytes_per_dev"] = int(b_id)
    for kind in list_compressors():
        comp = get_compressor(kind, block_size=BLOCK)
        b = vols[f"flat/{kind}"]["bytes"]
        results[f"{kind}_bytes_per_dev"] = int(b)
        results[f"{kind}_compression_x"] = round(b_id / max(b, 1), 2)
        results[f"{kind}_analytic_payload_ratio"] = round(
            4 * d / comp.wire_bytes(d), 2)
    ratio = b_id / vols["flat/onebit"]["bytes"]
    results["wire_compression_x"] = round(ratio, 2)
    # the paper's end-to-end claim with BERT-Large's warmup ratio 23K/152K
    w = 23_000 / 152_000
    results["paper_endtoend_volume_x_fp16"] = round(
        endtoend_volume_ratio(w, 16.0), 2)
    results["our_endtoend_volume_x_fp32"] = round(
        endtoend_volume_ratio(w, ratio), 2)
    spec = get_cluster("ethernet-10g", n_inner=VOL_INNER, n_outer=VOL_OUTER)
    for kind in list_compressors():
        comp = get_compressor(kind, block_size=BLOCK)
        hier = cross_pod_bytes(hier_schedule(
            comp, d, VOL_INNER, VOL_OUTER, ("data",), ("pod",),
            outer_ef=needs_outer_ef(comp)), spec)
        flat = cross_pod_bytes(flat_schedule(
            comp, d, VOL_INNER * VOL_OUTER, ("pod", "data"), tier="cross"),
            spec)
        results[f"hier_cross_pod_bytes_{kind}"] = hier
        results[f"flat_cross_pod_bytes_{kind}"] = flat
        results[f"hier_dci_reduction_x_{kind}"] = round(
            flat / max(hier, 1), 2)
    if verbose:
        print("== comm_volume (Fig. 3 / Sec. 6) ==")
        for k, v in results.items():
            print(f"  {k}: {v}")
        ok = ratio > 10.0
        ok_hier = results["hier_dci_reduction_x_onebit"] > VOL_INNER * 0.5
        print(f"  [{'PASS' if ok else 'FAIL'}] wire compression "
              f"{ratio:.1f}x > 10x")
        print(f"  [{'PASS' if ok_hier else 'FAIL'}] hierarchical schedule "
              f"cuts cross-pod bytes "
              f"{results['hier_dci_reduction_x_onebit']}x")
    return results


def cost_model_report() -> Dict[str, object]:
    """The tuner's tables for three cluster presets, with the pipelined
    bucket-count search and the plain-vs-kernel axis, and the per-bucket
    pipelined pricing of the hier/onebit exchange."""
    from repro_torch.optim import get_compressor
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.plan import (autotune, get_cluster, hier_schedule,
                                  pipeline_breakdown)
    report: Dict[str, object] = {}
    clusters = ("uniform", "ethernet-10g", "infiniband")
    for cluster in clusters:
        spec = get_cluster(cluster, n_inner=VOL_INNER, n_outer=VOL_OUTER)
        res = autotune(spec, D, block_sizes=(1024, 4096, 16384),
                       n_buckets_options=(1, 2, 4, 8),
                       use_kernel_options=(False, True))
        report[cluster] = res.summary()
    comp = get_compressor("onebit", block_size=BLOCK)
    plan = hier_schedule(comp, D, VOL_INNER, VOL_OUTER, ("data",), ("pod",))
    pipe = {}
    for cluster in clusters:
        spec = get_cluster(cluster, n_inner=VOL_INNER, n_outer=VOL_OUTER)
        pipe[cluster] = {
            nb: pipeline_breakdown(lower_to_pipelined(
                plan, comp, Bucketer.for_exchange(
                    D, VOL_INNER * VOL_OUTER, BLOCK, nb)), spec)
            for nb in (1, 2, 4, 8)}
    report["pipelined_hier_onebit"] = pipe
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check-plans", action="store_true",
                    help="hold plan.hlo_bytes() to the bytes counted on "
                         "spawned ranks, every compressor x topology, "
                         "serial and pipelined")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the --check-plans ranks' device")
    ap.add_argument("--d", type=int, default=D,
                    help="the --check-plans vector length")
    ap.add_argument("--block", type=int, default=BLOCK,
                    help="the --check-plans compression block")
    ap.add_argument("--json", default=None,
                    help="write the results and the cost-model tables here")
    args = ap.parse_args(argv)
    out = {}
    if args.check_plans:
        print(f"== comm_volume --check-plans: d={args.d}, block "
              f"{args.block}, {N_OUTER} x {N_INNER} ranks ({args.device}) "
              "==")
        out["plan_check"] = check_plans(args.d, args.block, args.device)
        print(f"all {len(out['plan_check'])} plans exact")
    else:
        out["volumes"] = run()
    out["cost_model"] = cost_model_report()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True, default=str)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
