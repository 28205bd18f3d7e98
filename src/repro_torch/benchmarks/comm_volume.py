"""The plan-versus-wire byte gate (``--check-plans``): the cost model's
collective bytes against the bytes the collectives are handed.

The port of ``benchmarks/comm_volume.py --check-plans``.  The reference
counts collective operand bytes in the compiled HLO; the port counts
them at the ``torch.distributed`` call boundary: a counting wrapper
around ``all_to_all_single`` (its input), ``all_gather_into_tensor`` /
``all_gather_single`` (its gathered output) and ``all_reduce`` (twice
its buffer, the convention of ``AllReduce.hlo_bytes``), installed by
this benchmark around each exchange and never by the library.

For every registered compressor it spawns 4 ranks (NCCL on 4 cards,
gloo on the CPU) on a 2 x 2 (pod x data) mesh, runs each plan through
the port's executors on seeded inputs, and asserts that
``plan.hlo_bytes()`` — and ``PipelinedPlan.hlo_bytes()`` for the
bucketed exchange — equals the bytes counted on every rank, exactly:

  * flat over n = 4 (one exchange over both axes);
  * hier 2 x 2 (the two-level schedule, the outer EF slots for top-k);
  * both pipelined with 2 and 4 buckets.

Bucketing changes when bytes move, never how many.

  python -m repro_torch.benchmarks.comm_volume --check-plans
  python -m repro_torch.benchmarks.comm_volume --check-plans --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.benchmarks.comm_sweep import init_rank, spawn

D = 1 << 20
BLOCK = 4096
MESH = "2x2x1"
N_INNER, N_OUTER = 2, 2
PIPE_BUCKETS = (2, 4)


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


class ByteCounter(contextlib.AbstractContextManager):
    """Counts the collective bytes this rank hands ``torch.distributed``
    while installed, by the plans' convention: all_to_all its input,
    all_gather its gathered output, all_reduce twice its buffer.
    ``calls`` records each call as (function name, bytes), in order."""

    def __init__(self):
        self.bytes = 0
        self.calls = []
        self._saved = {}

    def _wrap(self, name: str, nbytes):
        orig = getattr(dist, name)

        def counted(*args, **kwargs):
            n = nbytes(*args)
            self.bytes += n
            self.calls.append((name, n))
            return orig(*args, **kwargs)
        self._saved[name] = orig
        setattr(dist, name, counted)

    def __enter__(self):
        def size(t):
            return t.numel() * t.element_size()
        self._wrap("all_to_all_single", lambda out, inp, *a: size(inp))
        self._wrap("all_reduce", lambda t, *a: 2 * size(t))
        for name in ("all_gather_into_tensor", "all_gather_single"):
            if hasattr(dist, name):
                self._wrap(name, lambda out, inp, *a: size(out))
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(dist, name, orig)
        self._saved = {}
        return False


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


def run(verbose: bool = True, device: str = "cuda") -> Dict[str, dict]:
    """The harness's entry: ``check_plans`` at the default size."""
    if verbose:
        print(f"== comm_volume --check-plans: d={D}, block {BLOCK}, "
              f"{N_OUTER} x {N_INNER} ranks ({device}) ==")
    return check_plans(device=device, verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check-plans", action="store_true",
                    help="hold plan.hlo_bytes() to the counted bytes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--d", type=int, default=D)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--json", default=None,
                    help="write the comparison table here")
    args = ap.parse_args(argv)
    if not args.check_plans:
        ap.error("only --check-plans is ported (the HLO volume "
                 "measurement goes with the dry run)")
    print(f"== comm_volume --check-plans: d={args.d}, block {args.block}, "
          f"{N_OUTER} x {N_INNER} ranks ({args.device}) ==")
    table = check_plans(args.d, args.block, args.device)
    print(f"all {len(table)} plans exact")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(table, f, indent=2)


if __name__ == "__main__":
    main()
