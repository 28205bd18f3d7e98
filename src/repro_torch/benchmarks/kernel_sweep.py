"""Calibrate the device roofline: HBM bandwidth, per-launch overhead and
peak FLOP/s from timed kernels, written as the JSON that
``repro_torch.perf.device.DeviceSpec.from_measured`` loads.

The port of ``benchmarks/kernel_sweep.py``.  Every timed op is modelled
as the cost model prices it (``ComputeSpec.time``), linearised as a sum:

    t = kernels * kernel_overhead + hbm_bytes / hbm_bw + flops / peak_flops

exact where each op is firmly on one side of the roofline: the
compression, Adam and elementwise ops are memory-bound (their flops
column contributes next to nothing) and the bf16 matmul is compute-bound.
(kernels, hbm_bytes, flops) are the declared ComputeSpecs, so the fit
and the pricing stay in step.  The timed ops:

  * the port's ``ef_compress``, ``decompress`` and ``adam_step`` with
    their declared specs (the fused path on a CUDA device, the plain
    chain on the CPU);
  * chains of k = 1, 2, 4, 8 plain elementwise torch calls (``torch.add``
    into a buffer), each declared as k x ``elementwise_pass``: the
    differing launch counts separate the overhead from the bandwidth;
  * a bf16 ``torch.matmul`` of m x m, which makes ``peak_flops``
    observable (a measurement here, not a ported kernel).

Each op is timed over back-to-back calls between two CUDA events (the
host clock on the CPU), so ``kernel_overhead`` is the dispatch cost of a
launch.  The sizes reach 2^26 elements, where the bandwidth term
dominates, and start at 2^16, where the launches do.  The least squares
weighs each sample by its own time (relative residuals), so the small
launch-bound samples count as much as the large ones.  A fit that
clamps a term is a failed calibration: ``from_measured`` refuses it.

  python -m repro_torch.benchmarks.kernel_sweep --json device.json
  python -m repro_torch.benchmarks.kernel_sweep --device cpu \\
      --sizes 65536,262144 --block 1024       # the machinery on the CPU
  >>> DeviceSpec.from_measured("device.json")
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.train import resolve_device

SIZES = (1 << 16, 1 << 18, 1 << 24, 1 << 25, 1 << 26)
CHAIN = (1, 2, 4, 8)
BLOCK = 4096
REPS = 20
WINDOWS = 3


def fit_device(samples: Sequence[dict]) -> Dict[str, object]:
    """Least-squares (kernel_overhead, hbm_bw, peak_flops) from timed
    samples ``{op, d, kernels, hbm_bytes, flops, seconds}``, each row
    weighted by 1/seconds.

    Without a sample that does FLOPs ``peak_flops`` is None (not
    observed).  A non-positive coefficient means the timings do not
    resolve that term: it is clamped to a tiny positive value so the
    numbers stay finite, and ``clamped`` names it."""
    if not samples:
        raise ValueError("fit_device needs at least one timed sample")
    rows = np.asarray([[float(s["kernels"]), float(s["hbm_bytes"]),
                        float(s.get("flops", 0.0))] for s in samples])
    ts = np.asarray([float(s["seconds"]) for s in samples])
    if np.any(ts <= 0):
        raise ValueError("every timed sample needs a positive time")
    flops_observed = bool(np.any(rows[:, 2] > 0))
    if not flops_observed:
        rows = rows[:, :2]
    x, *_ = np.linalg.lstsq(rows / ts[:, None], np.ones_like(ts),
                            rcond=None)
    clamped = [name for name, v in
               (("kernel_overhead", x[0]), ("hbm_bw", x[1])) if v <= 0]
    if flops_observed and x[2] <= 0:
        clamped.append("peak_flops")
    peak = float(1.0 / x[2]) if flops_observed and x[2] > 0 else None
    return {"kernel_overhead": float(max(x[0], 1e-9)),
            "hbm_bw": 1.0 / float(max(x[1], 1e-15)),
            "peak_flops": peak, "clamped": clamped}


def _seconds_per_call(fn, dev: torch.device, reps: int = REPS,
                      windows: int = WINDOWS) -> float:
    """The least over ``windows`` of the mean seconds of ``reps``
    back-to-back calls (CUDA events on a card, the host clock on the
    CPU), after three warm-up calls."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(windows):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / reps)
    return best


def _ops(d: int, block: int, dev: torch.device, gen: torch.Generator):
    """(name, fn, ComputeSpec) of every op timed at size ``d``."""
    from repro_torch.kernels.fused_adam import ops as fa
    from repro_torch.kernels.onebit import ops as ob
    from repro_torch.optim.compressors import get_compressor
    from repro_torch.perf.kernel_cost import (ComputeSpec, adam_update_cost,
                                              elementwise_pass)
    fused = dev.type == "cuda"
    x = torch.randn(d, generator=gen).to(dev)
    e = (torch.randn(d, generator=gen) * 0.1).to(dev)
    v = e.abs() + 1e-3
    g = torch.randn(d, generator=gen).to(dev)
    specs = get_compressor("onebit", block_size=block).compute_specs(
        d, use_kernel=fused)
    packed, scales, _ = ob.ef_compress_fused(x, e, block)
    out = torch.empty_like(x)
    ops = [("ef_compress", lambda: ob.ef_compress_fused(x, e, block),
            specs["ef_compress"]),
           ("decompress",
            lambda: ob.decompress(packed, scales, block, out=out),
            specs["decompress"]),
           ("adam_step", lambda: fa.adam_step(x, e, v, g, 1e-3),
            adam_update_cost(d, fused=fused))]
    for k in CHAIN:
        def chain(k=k):
            for _ in range(k):
                torch.add(x, e, out=out)
        spec = elementwise_pass(d, 2, 1)
        ops.append((f"add_x{k}", chain,
                    ComputeSpec(k * spec.flops, k * spec.hbm_bytes, k)))
    # the compute-bound anchor: 2 m^3 flops on three m x m bf16 arrays
    m = (int(d ** 0.5) // 8) * 8
    if m >= 64:
        a = x[:m * m].reshape(m, m).to(torch.bfloat16)
        ops.append(("matmul_bf16", lambda: torch.matmul(a, a),
                    ComputeSpec(flops=2.0 * m ** 3,
                                hbm_bytes=3 * 2 * m * m, kernels=1)))
    return ops


def sweep(sizes: Sequence[int] = SIZES, block: int = BLOCK,
          device: str = "cuda", seed: int = 0) -> List[dict]:
    """Time every op at every size; one sample each."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    samples = []
    for d in sizes:
        if d % block:
            raise ValueError(f"size {d} is not a multiple of block {block}")
        for name, fn, spec in _ops(int(d), block, dev, gen):
            samples.append({"op": name, "d": int(d),
                            "kernels": int(spec.kernels),
                            "hbm_bytes": float(spec.hbm_bytes),
                            "flops": float(spec.flops),
                            "seconds": _seconds_per_call(fn, dev)})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return samples


def run(sizes: Sequence[int] = SIZES, block: int = BLOCK,
        device: str = "cuda", json_path: Optional[str] = None,
        verbose: bool = True) -> Dict[str, object]:
    """Sweep, fit, and write the ``DeviceSpec.from_measured`` JSON."""
    dev = resolve_device(device)
    samples = sweep(sizes, block, device)
    fit = fit_device(samples)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"name": f"measured-{dev.type}", "card": card,
           "backend": dev.type, "hbm_bw": fit["hbm_bw"],
           "kernel_overhead": fit["kernel_overhead"],
           "peak_flops": fit["peak_flops"], "clamped": fit["clamped"],
           "block_size": int(block), "samples": samples}
    if verbose:
        print(f"== kernel_sweep on {card} ({len(samples)} samples) ==")
        print(f"  hbm_bw          {fit['hbm_bw'] / 1e9:12.3f} GB/s")
        pf = fit["peak_flops"]
        print("  peak_flops      " + (f"{pf / 1e12:12.3f} TFLOP/s" if pf
                                      else "  not observed"))
        print(f"  kernel_overhead {fit['kernel_overhead'] * 1e6:12.3f} us")
        if fit["clamped"]:
            print(f"  fit clamped {fit['clamped']}: the timings do not "
                  "resolve these terms; DeviceSpec.from_measured refuses "
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
    ap.add_argument("--sizes", default=None,
                    help="comma-separated element counts (default "
                         "2^16, 2^18, 2^24, 2^25, 2^26)")
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None,
                    help="write the DeviceSpec.from_measured JSON here")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes \
        else SIZES
    run(sizes, args.block, args.device, json_path=args.json)


if __name__ == "__main__":
    main()
