"""Benchmark: allreduce share of step time (paper Table 1).

The paper profiles BERT-Large pre-training on Ethernet (4.1 Gbit/s
effective) and InfiniBand (~100 Gbit/s) clusters and finds allreduce takes
up to 94% / 75% of step time.  This reproduces the table analytically:

  t_comm(n, bw) = 2 * (n-1)/n * model_bytes / bw     (ring allreduce)
  t_compute     = the paper's measured fwd+bwd+step time (Table 1 row 1)

with the paper's own hardware constants (its V100 cluster; nothing here
is measured on this machine), then the same model with the 1-bit wire
compression applied.

With ``--telemetry DIR`` every row is also emitted as ``comm`` events of
the :mod:`repro_torch.obs` schema (one per compressor variant, ``source:
"analytic"``); with ``--ledger PATH`` the rows are written as a BENCH
ledger (one record per table row) for ``results/bench_compare.py``.  The
port of ``benchmarks/comm_fraction.py``: the same rows and records.

  python -m repro_torch.benchmarks.comm_fraction [--telemetry DIR] \
      [--ledger PATH]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.obs import as_sink

BERT_LARGE_PARAMS = 340e6
FP32 = 4
FP16 = 2

# paper Table 1: fwd, bwd-everything-else, step (ms) at batch 16/GPU
T_COMPUTE_MS = 35.71 + 60.81 + 75.59


def ring_allreduce_time_ms(model_bytes: float, n: int, bw_bits: float
                           ) -> float:
    bw = bw_bits / 8.0
    return 2.0 * (n - 1) / n * model_bytes / bw * 1e3


def compressed_time_ms(model_bytes_fp32: float, n: int, bw_bits: float,
                       compression: float = 32.0) -> float:
    """all_to_all (1/n each way) + allgather of 1-bit payloads ~=
    2 * (n-1)/n * compressed_bytes."""
    bw = bw_bits / 8.0
    return 2.0 * (n - 1) / n * (model_bytes_fp32 / compression) / bw * 1e3


def run(verbose: bool = True, telemetry=None, ledger: str = None
        ) -> List[Dict]:
    rows = []
    cases = [
        ("Ethernet", 4.1e9, 64), ("Ethernet", 4.1e9, 16),
        ("Ethernet", 4.1e9, 8), ("InfiniBand", 100e9, 64),
        ("InfiniBand", 100e9, 8),
    ]
    mb = BERT_LARGE_PARAMS * FP16
    sink = as_sink(telemetry, filename="comm_fraction.jsonl")
    for net, bw, n in cases:
        t_ar = ring_allreduce_time_ms(mb, n, bw)
        frac = t_ar / (t_ar + T_COMPUTE_MS)
        t_1b = compressed_time_ms(BERT_LARGE_PARAMS * FP32, n, bw)
        frac_1b = t_1b / (t_1b + T_COMPUTE_MS)
        rows.append({
            "network": net, "gbps": bw / 1e9, "gpus": n,
            "allreduce_ms": round(t_ar, 1),
            "allreduce_frac": round(frac, 3),
            "onebit_ms": round(t_1b, 1),
            "onebit_frac": round(frac_1b, 3),
        })
        for comp, t_ms, fr, nbytes in (
                ("none", t_ar, frac, mb),
                ("onebit", t_1b, frac_1b, BERT_LARGE_PARAMS * FP32 / 32)):
            sink.emit("comm", t_comm=t_ms / 1e3,
                      t_compute=T_COMPUTE_MS / 1e3,
                      label=f"{net}/{n}gpu/{comp}", n=n, gbps=bw / 1e9,
                      frac=fr, compressor=comp, bytes=float(nbytes),
                      source="analytic")
    sink.close()
    if telemetry and verbose:
        print(f"telemetry: {sink.n_events} events -> {sink.path}")
    if verbose:
        print("== comm_fraction (Table 1, analytic from paper constants) ==")
        for r in rows:
            print(f"  {r['network']:>10s} {r['gpus']:3d} GPUs: "
                  f"allreduce {r['allreduce_ms']:7.1f}ms "
                  f"({r['allreduce_frac']:.0%} of step) -> 1-bit "
                  f"{r['onebit_ms']:6.1f}ms ({r['onebit_frac']:.0%})")
        eth64 = rows[0]
        ok = eth64["allreduce_frac"] > 0.85  # paper: 93-94%
        print(f"  [{'PASS' if ok else 'FAIL'}] Ethernet/64GPU allreduce "
              f"fraction {eth64['allreduce_frac']:.0%} matches paper's ~93%")
    if ledger:
        from repro_torch.obs.bench import records_from_result, write_ledger
        payload = write_ledger(
            ledger, records_from_result("comm_fraction", rows),
            meta={"source": "analytic"})
        if verbose:
            print(f"  ledger: {len(payload['records'])} records "
                  f"-> {ledger}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="emit the obs event schema to "
                         "DIR/comm_fraction.jsonl (fold with "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="write the table rows as a BENCH perf ledger "
                         "(compare with results/bench_compare.py)")
    _a = ap.parse_args()
    run(telemetry=_a.telemetry, ledger=_a.ledger)
