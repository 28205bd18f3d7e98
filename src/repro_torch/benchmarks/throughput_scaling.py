"""Benchmark: throughput scalability (paper Fig. 5 + supplementary Fig. 9).

The same throughput model as ``comm_fraction`` (the paper's compute
constants + the 1-bit wire compression), swept over worker counts and
bandwidths, checking the paper's headline claims:

  * compression-stage speedup grows with worker count and saturates the
    compute bound (paper: 5.48x at 128 GPUs Ethernet, 6.6x at 1 Gbps);
  * uncompressed Adam's throughput PEAKS and then falls on Ethernet while
    1-bit Adam keeps scaling (Fig. 5b);
  * end-to-end speedup (incl. warmup) lands near the paper's 3.3x.

``--ledger PATH`` writes the swept cells as a BENCH ledger
(:mod:`repro_torch.obs.bench`), one record per (gpus, variant) point.
The port of ``benchmarks/throughput_scaling.py``: the same results and
records.

  python -m repro_torch.benchmarks.throughput_scaling [--ledger PATH]
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.benchmarks.comm_fraction import (
    BERT_LARGE_PARAMS, FP16, FP32, T_COMPUTE_MS, compressed_time_ms,
    ring_allreduce_time_ms)

SAMPLES_PER_STEP_PER_GPU = 16


def throughput(n: int, bw_bits: float, compressed: bool) -> float:
    """samples/sec for n workers."""
    if compressed:
        t_comm = compressed_time_ms(BERT_LARGE_PARAMS * FP32, n, bw_bits)
    else:
        t_comm = ring_allreduce_time_ms(BERT_LARGE_PARAMS * FP16, n, bw_bits)
    t_step = T_COMPUTE_MS + t_comm
    return n * SAMPLES_PER_STEP_PER_GPU / (t_step / 1e3)


def run(verbose: bool = True, ledger: str = None) -> Dict:
    eth = 4.1e9
    ns = [8, 16, 32, 64, 128, 256]
    tp_adam = [throughput(n, eth, False) for n in ns]
    tp_1bit = [throughput(n, eth, True) for n in ns]
    speedups = [b / a for a, b in zip(tp_adam, tp_1bit)]
    # bandwidth sweep at 256 GPUs (paper Fig. 9: up to 10.8x at 50 Mbps)
    bws = [50e6, 1e9, 2e9, 3e9, 4.1e9, 100e9]
    bw_speedup = {f"{int(b/1e6)}Mbps": round(
        throughput(256, b, True) / throughput(256, b, False), 2)
        for b in bws}
    # end-to-end: warmup fraction at paper's BERT-Large setting
    w = 23_000 / 152_000
    t_adam = 1.0 / throughput(64, eth, False)
    t_1bit = w / throughput(64, eth, False) + (1 - w) / throughput(
        64, eth, True)
    e2e = t_adam / t_1bit
    results = {
        "gpus": ns,
        "samples_s_adam": [round(x) for x in tp_adam],
        "samples_s_1bit": [round(x) for x in tp_1bit],
        "stage_speedup": [round(s, 2) for s in speedups],
        "bw_speedup_256gpu": bw_speedup,
        "endtoend_speedup_64gpu": round(e2e, 2),
    }
    if verbose:
        print("== throughput_scaling (Fig. 5 / Fig. 9) ==")
        for n, a, b, s in zip(ns, tp_adam, tp_1bit, speedups):
            print(f"  {n:4d} GPUs Ethernet: Adam {a:8.0f} 1-bit {b:8.0f} "
                  f"samples/s  ({s:.2f}x)")
        print(f"  bandwidth sweep @256: {bw_speedup}")
        print(f"  end-to-end speedup @64 GPUs (incl. warmup): {e2e:.2f}x")
        ok = 2.5 < e2e and speedups[-1] > 4.0 and \
            bw_speedup["50Mbps"] > bw_speedup["4100Mbps"]
        print(f"  [{'PASS' if ok else 'FAIL'}] matches paper's claims "
              f"(3.3x e2e, 5.5x stage, larger at lower bandwidth)")
    if ledger:
        from repro_torch.obs.bench import write_ledger
        recs = [
            *({"bench": "throughput_scaling",
               "config": f"eth/{n}gpu", "mesh": [n], "pipeline": 1,
               "kernels": False,
               "metrics": {"samples_s_adam": a, "samples_s_1bit": b,
                           "stage_speedup": s}}
              for n, a, b, s in zip(ns, tp_adam, tp_1bit, speedups)),
            {"bench": "throughput_scaling", "config": "e2e/64gpu",
             "mesh": [64], "pipeline": 1, "kernels": False,
             "metrics": {"endtoend_speedup": e2e}},
        ]
        payload = write_ledger(ledger, recs, meta={"source": "analytic"})
        if verbose:
            print(f"  ledger: {len(payload['records'])} records "
                  f"-> {ledger}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="write the swept cells as a BENCH perf ledger "
                         "(compare with results/bench_compare.py)")
    run(ledger=ap.parse_args().ledger)
