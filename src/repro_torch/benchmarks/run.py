"""Benchmark harness: one module per paper table/figure.

The port of ``benchmarks/run.py``; ``ALL`` binds the reference's twelve
names, in its order, to the port's modules:

  comm_volume         Fig. 3 / Sec. 6  (plan bytes == bytes handed to the
                                        collectives, every compressor)
  comm_fraction       Table 1          (allreduce share of step time)
  convergence         Fig. 1/4/6       (1-bit Adam ~ Adam; naive fails)
  resnet_convergence  Sec. 7.2/supp    (5-optimizer ResNet comparison)
  dcgan_convergence   Sec. 7.3/Fig. 8  (GAN equilibrium under 1-bit)
  variance_stability  Fig. 2           (v stabilizes; auto-warmup rule)
  throughput_scaling  Fig. 5 / Fig. 9  (scalability / bandwidth sweep)
  kernel_micro        (system)         (CUDA kernel vs plain + wire)
  block_size_ablation (ablation)       (scale granularity vs error/bits)
  comm_sweep          (system)         (measured per-tier α/β ->
                                        ClusterSpec.from_measured)
  kernel_sweep        (system)         (measured HBM bw + launch overhead
                                        -> DeviceSpec.from_measured)
  overlap_check       (system)         (NCCL kernels under other streams;
                                        SKIPs without them)

Run all: python -m repro_torch.benchmarks.run [--device cpu]
One:     python -m repro_torch.benchmarks.run --only convergence

Every benchmark runs on the card unless ``--device cpu``.  On the card,
``comm_volume``, ``comm_sweep`` and ``overlap_check`` need 4 cards (one
rank each); with fewer they are recorded as not run (never PASS), and the
harness exits non-zero when ``--only`` named one.  On the CPU they spawn
gloo ranks.

``--json OUT`` routes every benchmark's result dict through the BENCH
perf-ledger writer (:mod:`repro_torch.obs.bench`): OUT is a canonical
``BENCH_all.json`` — ``{"schema": "repro.obs.bench/v1", ...}`` with one
record per named numeric cell — that ``results/bench_compare.py`` can
diff against any other ledger.  ``--raw-json OUT`` keeps the unvalidated
result dump.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.benchmarks import (block_size_ablation, comm_fraction,
                                    comm_sweep, comm_volume, convergence,
                                    dcgan_convergence, kernel_micro,
                                    kernel_sweep, overlap_check,
                                    resnet_convergence, throughput_scaling,
                                    variance_stability)

ALL = {
    "comm_volume": comm_volume.run_check_plans,
    "comm_fraction": comm_fraction.run,
    "variance_stability": variance_stability.run,
    "convergence": convergence.run,
    "resnet_convergence": resnet_convergence.run,
    "dcgan_convergence": dcgan_convergence.run,
    "throughput_scaling": throughput_scaling.run,
    "kernel_micro": kernel_micro.run,
    "block_size_ablation": block_size_ablation.run,
    "comm_sweep": comm_sweep.run,
    "kernel_sweep": kernel_sweep.run,
    "overlap_check": overlap_check.run,
}
# cards an entry needs on the card (one rank each); the rest need one
CARDS = {"comm_volume": 4, "comm_sweep": 4, "overlap_check": 4}
# analytic entries: host math only, no device argument
HOST_ONLY = ("comm_fraction", "throughput_scaling")


def not_run(name: str, device: str) -> Optional[str]:
    """Why ``name`` cannot run on ``device`` here, or None."""
    need = CARDS.get(name, 1)
    if device != "cuda" or need == 1:
        return None
    have = torch.cuda.device_count()
    return f"needs {need} cards, {have} present" if have < need else None


def run_benchmarks(names: Sequence[str], device: str = "cuda"
                   ) -> Dict[str, object]:
    """Each named benchmark's result dict (``{"not_run": why}`` for one
    that needs more cards than there are), with its seconds printed."""
    out = {}
    for name in names:
        why = not_run(name, device)
        if why:
            print(f"== {name} ==\n  not run: {why}\n")
            out[name] = {"not_run": why}
            continue
        kw = {} if name in HOST_ONLY else {"device": device}
        t0 = time.time()
        out[name] = ALL[name](verbose=True, **kw)
        print(f"  ({time.time() - t0:.1f}s)\n")
    return out


def write_json(path: str, out: Dict[str, object], names: Sequence[str],
               device: str) -> dict:
    """The results as one BENCH ledger (``repro.obs.bench/v1``)."""
    from repro_torch.obs.bench import records_from_result, write_ledger
    records = []
    for name, result in out.items():
        records += records_from_result(name, result)
    return write_ledger(path, records, meta={
        "source": "benchmarks.run", "benchmarks": list(names),
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", choices=list(ALL), default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write all results as one BENCH_all.json "
                         "perf ledger (repro.obs.bench schema)")
    ap.add_argument("--raw-json", default=None, metavar="OUT",
                    help="also dump the raw result dicts")
    args = ap.parse_args(argv)
    names = [args.only] if args.only else list(ALL)
    out = run_benchmarks(names, args.device)
    if args.raw_json:
        with open(args.raw_json, "w") as f:
            json.dump(out, f, indent=2, default=str)
    if args.json:
        payload = write_json(args.json, out, names, args.device)
        print(f"ledger: {len(payload['records'])} records -> {args.json}")
    skipped = [n for n in names if "not_run" in out[n]]
    print(f"ran {len(names) - len(skipped)} benchmarks"
          + (f", not run: {', '.join(skipped)}" if skipped else ""))
    return 1 if args.only and skipped else 0


if __name__ == "__main__":
    sys.exit(main())
