#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

  1. device  — requires CUDA; prints the card's name and power limit
               (nvidia-smi); TF32 off for matmuls and cuDNN.
  2. build   — builds the port's Hopper kernels from ``src/repro_torch/csrc``
               and prints the build seconds.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes (BERT-Large, d_pad = 364,564,480,
               block 4096), with CUDA-event times of both and the
               device-memory bound.
  4. small   — the port's ``run`` on ``bert-large-smoke`` on the card and on
               the CPU from the same seed: the loss histories must agree.
  5. main    — the main path through the user entry point
               ``repro_torch.launch.train.run``: full-width, full-depth
               BERT-Large, 3 warmup + 3 compressed 1-bit Adam steps, batch
               16 x seq 128; launch counts read around exactly this run.
  6. profile — one more warmup-stage and compressed-stage step on the
               main path's model under torch.profiler: device time by
               kernel group and the device's idle share (measurement only).

It prints the ``{"kernels": [...]}`` line, the card line, and as its last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# H100 SXM peak rates (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN = dict(arch="bert-large", recipe="onebit_adam", steps=6,
            warmup_steps=3, batch=16, seq=128, block_size=4096)
SMALL = dict(arch="bert-large-smoke", recipe="onebit_adam", steps=5,
             warmup_steps=3, batch=4, seq=64, block_size=512, lr=2e-3,
             lr_warmup=2)
# cuBLAS and the CPU BLAS sum in other orders; after the switch a ULP
# difference near zero can flip single sign bits of the 1-bit payload
SMALL_LOSS_RTOL = 1e-3
EXPECTED_LAUNCHES = {"adam_step": 3, "ef_compress": 6, "decompress": 6}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.time()
    lib = build.build(verbose=True)
    build.load()
    secs = time.time() - t0
    log(f"[build] {lib} in {secs:.1f} s")
    return secs


def phase_kernels(d: int, block: int, seed: int = 0):
    """Each kernel against its plain version at (d,) f32, block ``block``;
    returns the kernel entries of the JSON line (launches filled later)."""
    from repro_torch.kernels.fused_adam import kernel as FK
    from repro_torch.kernels.fused_adam import ref as FR
    from repro_torch.kernels.onebit import kernel as OK
    from repro_torch.kernels.onebit import ref as OR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(scale=1.0):
        return torch.randn(d, generator=gen, device=dev) * scale

    entries = []
    x, err = randn(), randn(0.1)
    pk, sc, ne = OK.ef_compress_fused(x, err, block)
    pk_r, sc_r, ne_r = OR.ef_compress_fused(x, err, block)
    torch.cuda.synchronize()
    if not torch.equal(pk, pk_r):
        n_bad = int((pk != pk_r).sum())
        raise AssertionError(f"ef_compress: packed differs in {n_bad} bytes")
    torch.testing.assert_close(sc, sc_r, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ne, ne_r, rtol=1e-5, atol=1e-6)
    err_max = max(float((sc - sc_r).abs().max()),
                  float((ne - ne_r).abs().max()))
    del pk, sc, ne, ne_r
    ms = time_ms(lambda: OK.ef_compress_fused(x, err, block))
    plain = time_ms(lambda: OR.ef_compress_fused(x, err, block))
    b_ms, b_by = bound(12 * d + d / 8 + 4 * d / block, 5 * d)
    entries.append(dict(
        name="ef_compress", route="cuda",
        source="src/repro_torch/csrc/onebit.cu",
        replaces="src/repro/kernels/onebit/kernel.py:59", ok=True,
        max_abs_err=err_max, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launches_per_step=2))
    log(f"[kernels] ef_compress ok: {ms:.3f} ms (plain {plain:.3f} ms, "
        f"bound {b_ms:.3f} ms), max abs err {err_max:.3e}")
    del x, err

    out = OK.decompress(pk_r, sc_r, block)
    out_r = OR.decompress(pk_r, sc_r, block)
    if not torch.equal(out, out_r):
        raise AssertionError("decompress: output is not bitwise the plain "
                             "version")
    del out, out_r
    ms = time_ms(lambda: OK.decompress(pk_r, sc_r, block))
    plain = time_ms(lambda: OR.decompress(pk_r, sc_r, block))
    b_ms, b_by = bound(4 * d + d / 8 + 4 * d / block, d)
    entries.append(dict(
        name="decompress", route="cuda",
        source="src/repro_torch/csrc/onebit.cu",
        replaces="src/repro/kernels/onebit/kernel.py:95", ok=True,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launches_per_step=2))
    log(f"[kernels] decompress ok (bitwise): {ms:.3f} ms (plain "
        f"{plain:.3f} ms, bound {b_ms:.3f} ms)")
    del pk_r, sc_r
    torch.cuda.empty_cache()

    xa, m, g = randn(), randn(0.01), randn(0.01)
    v = randn(1e-4).abs()
    err_max = 0.0
    for wd in (0.0, 0.01):
        got = FK.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
        want = FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-7)
            err_max = max(err_max, float((a - b).abs().max()))
        del got, want
    ms = time_ms(lambda: FK.adam_step(xa, m, v, g, 1e-3))
    plain = time_ms(lambda: FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999,
                                         1e-8))
    b_ms, b_by = bound(28 * d, 12 * d)
    entries.append(dict(
        name="adam_step", route="cuda",
        source="src/repro_torch/csrc/fused_adam.cu",
        replaces="src/repro/kernels/fused_adam/kernel.py:44", ok=True,
        max_abs_err=err_max, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launches_per_step=1))
    log(f"[kernels] adam_step ok: {ms:.3f} ms (plain {plain:.3f} ms, "
        f"bound {b_ms:.3f} ms), max abs err {err_max:.3e}")
    del xa, m, v, g
    torch.cuda.empty_cache()
    return entries


def phase_small() -> None:
    """The port's run on the card and on the CPU from one seed agree."""
    from repro_torch.launch.train import run
    card = run(device="cuda", **SMALL)["history"]
    cpu = run(device="cpu", **SMALL)["history"]
    for a, b in zip(card, cpu):
        if a["stage"] != b["stage"] or not math.isfinite(a["loss"]):
            raise AssertionError(f"small run: step {a} vs cpu {b}")
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        if rel > SMALL_LOSS_RTOL:
            raise AssertionError(f"small run step {a['step']}: loss "
                                 f"{a['loss']} on the card vs {b['loss']} "
                                 f"on the CPU (rel {rel:.2e})")
    log("[small] card vs cpu losses: " + ", ".join(
        f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in zip(card, cpu)))


def phase_main():
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = run(device="cuda", **MAIN)
    counts = build.launch_counts()
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    stages = [h["stage"] for h in hist]
    w = MAIN["warmup_steps"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if stages != ["warmup"] * w + ["compressed"] * (MAIN["steps"] - w):
        raise AssertionError(f"stage did not flip at step {w}: {stages}")
    v_l1 = [h["v_l1"] for h in hist[w - 1:]]
    if len(set(v_l1)) != 1:
        raise AssertionError(f"v changed in the compressed stage: {v_l1}")
    if counts != EXPECTED_LAUNCHES or res["launches"] != counts:
        raise AssertionError(f"launch counts {counts} (run says "
                             f"{res['launches']}), expected "
                             f"{EXPECTED_LAUNCHES}")
    tokens = MAIN["batch"] * MAIN["seq"]
    warm_ms = [h["ms"] for h in hist[:w]]
    comp_ms = [h["ms"] for h in hist[w:]]
    steady = sorted(comp_ms)[len(comp_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] d={res['d']} d_pad={res['d_pad']} losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[main] warmup step ms {warm_ms}, compressed step ms {comp_ms}, "
        f"tokens/s {tokens / (steady / 1e3):.1f} (median compressed step), "
        f"peak memory {peak} bytes")
    return counts, dict(warmup_step_ms=warm_ms, compressed_step_ms=comp_ms,
                        tokens_per_s=tokens / (steady / 1e3),
                        peak_bytes=peak, losses=losses), res["state"]


def _kernel_group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("ef_compress_kernel", "decompress_kernel",
                              "adam_kernel")):
        return "port kernels (csrc)"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def phase_profile(state) -> dict:
    """One warmup-stage and one compressed-stage step of the main path's
    model and state under torch.profiler, after the untraced run: device
    time by kernel group, the top kernels, and the device's idle share of
    the step's wall time.  A measurement, not a gate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import train_step
    cfg = get_config(MAIN["arch"])
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": MAIN["block_size"]})
    stream = SyntheticStream(
        cfg, InputShape("profile", MAIN["seq"], MAIN["batch"], "train"),
        seed=1, device="cuda")
    out = {}
    for i, stage in enumerate(("warmup", "compressed")):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(state, opt, batch, 1e-4, stage)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        by_name, by_group = {}, {}
        for e in kernels:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
            g = _kernel_group(e.name)
            by_group[g] = by_group.get(g, 0.0) + us / 1e3
        busy = sum(by_group.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[stage] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "n_kernels": len(kernels), "by_group_ms": by_group,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
        log(f"[profile] {stage}: wall {wall_ms:.1f} ms, device busy "
            f"{busy:.1f} ms over {len(kernels)} kernels; " + ", ".join(
                f"{g} {ms:.1f} ms" for g, ms in sorted(by_group.items())))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.train.step import flat_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    phase_build()
    d_pad = flat_dim(get_config(MAIN["arch"]), 1, MAIN["block_size"])
    log(f"[kernels] main-path d_pad = {d_pad}")
    entries = phase_kernels(d_pad, MAIN["block_size"])
    phase_small()
    counts, stats, state = phase_main()
    stats["profile"] = phase_profile(state)
    for e in entries:
        e["launches"] = counts[e["name"]]
        e["kernel_ms"] = e["ms"]
    print(json.dumps({"main_path": stats}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
