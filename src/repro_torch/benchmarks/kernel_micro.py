"""Benchmark: compression-kernel microbenchmark.

The port of ``benchmarks/kernel_micro.py``.  At d = 2^16 and 2^20, block
4096, on the reference's numpy inputs:
  * the ``ef_compress`` kernel against its plain version: the packed
    signs bitwise, the scales at rtol 1e-6 and ``new_err`` at rtol 1e-5 /
    atol 1e-6 (the block mean sums in another order than torch's mean, so
    the reference's ``== 0.0`` on ``new_err`` does not carry over), and
    the ``decompress`` kernel bitwise its plain version;
  * wire bytes per scheme;
  * the compress throughput of the kernel and of the plain version on the
    card (4d bytes over the median CUDA-event time of 10 calls).

With ``--device cpu`` there is no kernel: the result keeps the wire
bytes only, with no ``kernel_vs_ref_err``.

  python -m repro_torch.benchmarks.kernel_micro [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core.compression import CompressionConfig, wire_bytes
from repro_torch.kernels.onebit import kernel as K
from repro_torch.kernels.onebit import ref as R
from repro_torch.launch.train import resolve_device

SIZES = (1 << 16, 1 << 20)
BLOCK = 4096
SCALE_RTOL = 1e-6
ERR_TOL = dict(rtol=1e-5, atol=1e-6)


def _gbps(fn, nbytes: int, reps: int = 10) -> float:
    """nbytes over the median CUDA-event time of ``reps`` calls."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return round(nbytes / sorted(times)[reps // 2] / 1e9, 2)


def _check(x: torch.Tensor, e: torch.Tensor) -> Dict:
    pk_k, sc_k, ne_k = K.ef_compress_fused(x, e, BLOCK)
    pk_r, sc_r, ne_r = R.ef_compress_fused(x, e, BLOCK)
    d = x.shape[0]
    zeros = torch.zeros_like(x)
    return {
        "kernel_vs_ref_err": float((ne_k - ne_r).abs().max()),
        "packed_bitwise": bool(torch.equal(pk_k, pk_r)),
        "scales_max_rel_err": float(((sc_k - sc_r).abs()
                                     / sc_r.abs()).max()),
        "within_tol": bool(
            torch.allclose(sc_k, sc_r, rtol=SCALE_RTOL, atol=0.0)
            and torch.allclose(ne_k, ne_r, **ERR_TOL)),
        "decompress_bitwise": bool(torch.equal(
            K.decompress(pk_r, sc_r, BLOCK), R.decompress(pk_r, sc_r,
                                                          BLOCK))),
        "kernel_compress_gbps": _gbps(
            lambda: K.ef_compress_fused(x, zeros, BLOCK), 4 * d),
        "plain_compress_gbps": _gbps(
            lambda: R.ef_compress_fused(x, zeros, BLOCK), 4 * d),
    }


def run(verbose: bool = True, device: str = "cuda") -> Dict:
    dev = resolve_device(device)
    results = {}
    rng = np.random.default_rng(0)
    for d in SIZES:
        x = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
        e = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)) * 0.1
        cfg = CompressionConfig()
        row = {"wire_bytes": wire_bytes(d, cfg), "fp32_bytes": 4 * d,
               "ratio": round(4 * d / wire_bytes(d, cfg), 1)}
        if dev.type == "cuda":
            row.update(_check(x.to(dev), e.to(dev)))
        results[f"d={d}"] = row
    if verbose:
        print("== kernel_micro ==")
        for k, v in results.items():
            print(f"  {k}: {v}")
        if dev.type != "cuda":
            print("  [SKIP] no kernel on the CPU: wire bytes only")
        else:
            ok = passes(results)
            print(f"  [{'PASS' if ok else 'FAIL'}] CUDA kernels vs their "
                  f"plain versions: packed signs and decompress bitwise, "
                  f"scales rtol {SCALE_RTOL}, new_err rtol "
                  f"{ERR_TOL['rtol']} / atol {ERR_TOL['atol']}")
    return results


def passes(results: Dict) -> bool:
    """The card's verdict (False on a CPU result, which has no kernel)."""
    return all("packed_bitwise" in v and v["packed_bitwise"]
               and v["within_tol"] and v["decompress_bitwise"]
               for v in results.values())


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
