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
  7. flash   — both flash-attention kernels against their plain version on
               the card: the SIMT kernel (the f32 route) on small f32 shapes
               (S 128/256/512, D 32/64/128, causal and not, windows
               32/64/128); the tensor-core kernel (the bf16/fp16 route) on
               ragged fp16 shapes; head dims 48/80/96/256 (zero-padded) in
               f32, bf16 and fp16; then the serving shape (8, 24, 2048, 128)
               bf16 causal, with CUDA-event times of the tensor-core kernel,
               the SIMT kernel on the same bf16 inputs, the plain version and
               PyTorch's scaled_dot_product_attention (timed only), the
               bound, and the HGMMA instructions in the built library's
               SASS (cuobjdump, where the toolkit has it).
  8. serve-small — the port's ServeEngine on ``llama3.2-3b-smoke`` with
               attn_impl="pallas", on the card and on the CPU from one seed:
               prefill logits and 8 teacher-forced decode steps agree.
  9. serve-main — the serving path through the user entry point
               ``repro_torch.serve.ServeEngine.generate``: full-width,
               full-depth llama3.2-3b, random weights from seed 0, batch 8
               x 2048-token prompts, 32 greedy new tokens; launch counts
               read around exactly this run (28 launches of the
               tensor-core flash kernel, none of the SIMT one).
 10. serve-profile — one prefill and one decode step under torch.profiler
               (measurement only).

Launch counts are set to 0 just before each main path (training in phase
5, serving in phase 9) and read just after it.  It prints the
``{"kernels": [...]}`` line, the card line, and as its last line
``{"ok": true, "device": {...}}``.
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
BF16_TENSOR_OPS_PER_S = 989e12

MAIN = dict(arch="bert-large", recipe="onebit_adam", steps=6,
            warmup_steps=3, batch=16, seq=128, block_size=4096)
SMALL = dict(arch="bert-large-smoke", recipe="onebit_adam", steps=5,
             warmup_steps=3, batch=4, seq=64, block_size=512, lr=2e-3,
             lr_warmup=2)
# cuBLAS and the CPU BLAS sum in other orders; after the switch a ULP
# difference near zero can flip single sign bits of the 1-bit payload
SMALL_LOSS_RTOL = 1e-3
EXPECTED_LAUNCHES = {"adam_step": 3, "ef_compress": 6, "decompress": 6,
                     "flash_attention": 0, "flash_attention_wgmma": 0}
# block sizes beside the main path's 4096 that ef_compress must take
# (multiples of 8 that are not multiples of 32, and one that is)
SMALL_BLOCKS = (8, 24, 40, 520)

SERVE = dict(arch="llama3.2-3b", batch=8, prompt=2048, new_tokens=32,
             seed=0)
SERVE_SMALL = dict(arch="llama3.2-3b-smoke", batch=2, prompt=64, steps=8,
                   seed=0)
# f32 on both sides (TF32 off); cuBLAS and the CPU BLAS, and the kernel's
# online softmax and the plain one, sum in other orders: the tolerance of
# tests/test_kernels.py's prefill test
SERVE_SMALL_TOL = dict(rtol=1e-4, atol=1e-4)
# every 16-bit check: the rtol of tests/test_kernels.py:176; the
# tensor-core kernel also rounds p to bf16 (relative 2^-8) before p v, the
# plain version keeps it in f32. The least atol that passes at this rtol
# reads 2.9e-3 at the serving shape (bf16, where 71 % of outputs have
# |o| < 1/16) and at most 1.5e-3 in the other bf16 and fp16 cases, on an
# H100; that test's atol of 2e-2 would be a third of the 1/16 under which
# most outputs lie here
FLASH_BF16_TOL = dict(rtol=2e-2, atol=5e-3)
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-6)
# at the serving shape the share of outputs bitwise the plain version's
# must stay above this: a kernel wrong in a minority of rows, where the
# outputs are small, would pass the tolerance alone
FLASH_BITWISE_FLOOR = 0.5
# |o| under this counts as a small output in the readings
FLASH_SMALL_O = 1 / 16


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


def atol_needed(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The least atol at which ``got`` is close to ``want`` at ``rtol``."""
    g, w = got.float(), want.float()
    return max(0.0, float(((g - w).abs() - rtol * w.abs()).max()))


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate for their type (f32 by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    for blk in SMALL_BLOCKS:
        xs = torch.randn(64 * blk, generator=gen, device=dev)
        es = torch.randn(64 * blk, generator=gen, device=dev) * 0.1
        got, want = (OK.ef_compress_fused(xs, es, blk),
                     OR.ef_compress_fused(xs, es, blk))
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"ef_compress block {blk}: packed is not "
                                 "bitwise the plain version")
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    log(f"[kernels] ef_compress at blocks {SMALL_BLOCKS}: packed bitwise")
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
    if "flash_fwd" in low:
        return "flash attention (csrc)"
    if any(k in low for k in ("ef_compress_kernel", "decompress_kernel",
                              "adam_kernel")):
        return "port kernels (csrc)"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def _device_breakdown(prof, wall_ms: float) -> dict:
    """Device time by kernel group and by name, and the device's idle
    share of ``wall_ms``, from one torch.profiler trace."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_group = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        g = _kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + ms
    busy = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "n_kernels": len(kernels), "by_group_ms": by_group,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def _log_breakdown(tag: str, what: str, r: dict) -> None:
    log(f"[{tag}] {what}: wall {r['wall_ms']:.1f} ms, device busy "
        f"{r['device_busy_ms']:.1f} ms over {r['n_kernels']} kernels; "
        + ", ".join(f"{g} {ms:.1f} ms"
                    for g, ms in sorted(r["by_group_ms"].items())))


def phase_profile(state) -> dict:
    """One warmup-stage and one compressed-stage step of the main path's
    model and state under torch.profiler, after the untraced run: device
    time by kernel group, the top kernels, and the device's idle share of
    the step's wall time.  A measurement, not a gate."""
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
        out[stage] = _device_breakdown(prof, wall_ms)
        _log_breakdown("profile", stage, out[stage])
    return out


def _hgmma_count(lib_path) -> int:
    """HGMMA instructions in the SASS of the built library, or -1 where
    the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return -1
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_flash(seed: int = 0):
    """Both flash-attention kernels against their plain version: small
    f32 shapes (SIMT) at tests/test_kernels.py's tolerance, ragged fp16
    shapes (tensor cores), padded head dims in every dtype, then the
    serving shape in bf16, timed beside the SIMT kernel, the plain version
    and PyTorch's fused attention.  Returns the two kernels' entries of the
    JSON line (launches filled later)."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol16 = "rtol {rtol}, atol {atol}".format(**FLASH_BF16_TOL)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def check(shape, dtype, causal, window, counter):
        q, k, v = qkv(shape, dtype)
        before = build.launch_counts()[counter]
        got = FK.flash_attention(q, k, v, causal=causal, window=window)
        if build.launch_counts()[counter] != before + 1:
            raise AssertionError(f"flash {shape} {dtype}: not routed to "
                                 f"{counter}")
        want = FR.sdpa(q, k, v, causal=causal, window=window)
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        need = atol_needed(got, want, tol["rtol"])
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return float((got.float() - want.float()).abs().max()), need

    cases = [(s, d, causal, None) for s in (128, 256, 512)
             for d in (32, 64, 128) for causal in (True, False)]
    cases += [(256, 64, True, w) for w in (32, 64, 128)]
    err_f32 = max(check((1, 2, s, d), torch.float32, causal, window,
                        "flash_attention")[0]
                  for s, d, causal, window in cases)
    log(f"[flash] {len(cases)} small f32 cases (SIMT) ok (rtol 1e-5, atol "
        f"2e-6), max abs err {err_f32:.3e}")
    fp16 = [(s, d, causal, w) for s in (200, 320) for d in (64, 128)
            for causal, w in ((True, None), (False, None), (True, 64))]
    f16 = [check((2, 3, s, d), torch.float16, causal, window,
                  "flash_attention_wgmma") for s, d, causal, window in fp16]
    err_f16 = max(e for e, _ in f16)
    log(f"[flash] {len(fp16)} ragged fp16 cases (tensor cores) ok "
        f"({tol16}), max abs err {err_f16:.3e}, least atol that passes at "
        f"that rtol {max(n for _, n in f16):.3e}")
    pad, pad_need = {}, {}
    for d in (48, 80, 96, 256):
        for dtype, counter in ((torch.float32, "flash_attention"),
                               (torch.bfloat16, "flash_attention_wgmma"),
                               (torch.float16, "flash_attention_wgmma")):
            key = f"{d}/{str(dtype)[6:]}"
            pad[key], pad_need[key] = check((1, 2, 320, d), dtype, True,
                                            None, counter)
    log("[flash] padded head dims ok, max abs err " + ", ".join(
        f"{k} {v:.2e}" for k, v in pad.items()) + "; least atol that "
        "passes at the case's rtol " + ", ".join(
        f"{k} {v:.2e}" for k, v in pad_need.items()))

    b, h, s, d = 8, 24, 2048, 128
    q, k, v = qkv((b, h, s, d), torch.bfloat16)
    want = FR.sdpa(q, k, v, causal=True)
    stats = {}
    for name, fn in (("flash_attention_wgmma", FK.flash_attention),
                     ("flash_attention", FK.flash_attention_simt)):
        got = fn(q, k, v, causal=True)
        err = (got.float() - want.float()).abs()
        small = want.float().abs() < FLASH_SMALL_O
        stats[name] = dict(
            err=float(err.max()),
            err_small_o=float(err[small].max()),
            small_o_share=float(small.float().mean()),
            atol_needed=atol_needed(got, want, FLASH_BF16_TOL["rtol"]),
            same=float((got.view(torch.int16) == want.view(torch.int16))
                       .float().mean()))
        del err, small
        log(f"[flash] {name} at (8, 24, 2048, 128) bf16 causal: max abs err "
            f"{stats[name]['err']:.3e}, at |o| < {FLASH_SMALL_O} "
            f"({stats[name]['small_o_share']:.4f} of outputs) "
            f"{stats[name]['err_small_o']:.3e}; least atol that passes at "
            f"rtol {FLASH_BF16_TOL['rtol']} "
            f"{stats[name]['atol_needed']:.3e}; "
            f"{stats[name]['same']:.4f} of outputs bitwise the plain "
            "version's")
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_BF16_TOL)
        if stats[name]["same"] < FLASH_BITWISE_FLOOR:
            raise AssertionError(f"flash {name}: only {stats[name]['same']} "
                                 "of outputs bitwise the plain version's")
        del got
    del want
    torch.cuda.empty_cache()
    stats["flash_attention_wgmma"]["ms"] = time_ms(
        lambda: FK.flash_attention(q, k, v, causal=True))
    stats["flash_attention"]["ms"] = time_ms(
        lambda: FK.flash_attention_simt(q, k, v, causal=True), reps=5)
    plain = time_ms(lambda: FR.sdpa(q, k, v, causal=True), reps=5)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    # each of q, k, v read once and o written once; the causal half of
    # the two (S x S x D) products
    n_bytes = 4 * b * h * s * d * q.element_size()
    n_ops = 2 * b * h * s * s * d
    b_ms, b_by = bound(n_bytes, n_ops, BF16_TENSOR_OPS_PER_S)
    hgmma = _hgmma_count(build.build())
    if hgmma == 0:
        raise AssertionError("flash: no HGMMA instruction in the library")
    for name, st in stats.items():
        log(f"[flash] {name} at (8, 24, 2048, 128) bf16 causal ok "
            f"({tol16}; {st['same']:.4f} of outputs bitwise the plain "
            f"version's, floor {FLASH_BITWISE_FLOOR}), max abs err "
            f"{st['err']:.3e}; {st['ms']:.3f} ms, "
            f"{n_ops / (st['ms'] / 1e3) / 1e12:.1f} TFLOP/s")
    log(f"[flash] plain {plain:.3f} ms, scaled_dot_product_attention "
        f"{lib:.3f} ms, bound {b_ms:.3f} ms by {b_by}; HGMMA instructions "
        f"in the library's SASS: {hgmma}")
    del q, k, v
    torch.cuda.empty_cache()
    common = dict(route="cuda",
                  replaces="src/repro/kernels/flash_attn/kernel.py:84",
                  ok=True, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                  library_ms=lib)
    wgmma = dict(
        name="flash_attention_wgmma",
        source="src/repro_torch/csrc/flash_attn_sm90.cu",
        max_abs_err=stats["flash_attention_wgmma"]["err"],
        max_abs_err_fp16_ragged=err_f16,
        max_abs_err_small_o=stats["flash_attention_wgmma"]["err_small_o"],
        atol_needed=stats["flash_attention_wgmma"]["atol_needed"],
        atol_needed_padded=pad_need,
        bitwise_share=stats["flash_attention_wgmma"]["same"],
        ms=stats["flash_attention_wgmma"]["ms"], hgmma_in_sass=hgmma,
        launches_per_prefill=28, **common)
    simt = dict(
        name="flash_attention", source="src/repro_torch/csrc/flash_attn.cu",
        max_abs_err=stats["flash_attention"]["err"],
        max_abs_err_f32_small=err_f32,
        bitwise_share=stats["flash_attention"]["same"],
        ms=stats["flash_attention"]["ms"], timed_on="bf16 serving shape",
        max_abs_err_padded=pad, **common)
    return simt, wgmma


def _teacher_forced(eng, toks: torch.Tensor, s: int, n: int):
    """Prefill logits and ``n`` teacher-forced decode logits of ``eng``'s
    model on ``toks`` (B, s + n), as f32 on the CPU."""
    from repro_torch.models import transformer as T
    cfg = eng.cfg
    toks = toks.to(eng.device)
    with torch.inference_mode():
        logits, caches = T.prefill(eng.params, {"tokens": toks[:, :s]}, cfg,
                                   cache_len=s + n)
        out = [logits.float().cpu()]
        for i in range(n):
            logits, caches = T.decode_step(
                eng.params, {"tokens": toks[:, s + i:s + i + 1]}, caches,
                s + i, cfg)
            out.append(logits.float().cpu())
    return out


def phase_serve_small() -> float:
    """The serving engine's model on the card and on the CPU from one
    seed, with attn_impl="pallas": prefill and 8 teacher-forced decode
    steps give the same logits within SERVE_SMALL_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    sp = SERVE_SMALL
    cfg = dataclasses.replace(get_config(sp["arch"]), attn_impl="pallas")
    params = T.init_params(cfg, torch.Generator().manual_seed(sp["seed"]))
    toks = torch.randint(0, cfg.vocab, (sp["batch"], sp["prompt"]
                                        + sp["steps"]),
                         generator=torch.Generator().manual_seed(1))
    before = build.launch_counts()
    card = _teacher_forced(ServeEngine(cfg, params, device="cuda"), toks,
                           sp["prompt"], sp["steps"])
    after = build.launch_counts()
    if (after["flash_attention"] != before["flash_attention"] + cfg.n_layers
            or after["flash_attention_wgmma"]
            != before["flash_attention_wgmma"]):
        raise AssertionError("serve-small: the card's f32 prefill did not "
                             "run the SIMT flash kernel once per layer")
    cpu = _teacher_forced(ServeEngine(cfg, params, device="cpu"), toks,
                          sp["prompt"], sp["steps"])
    err = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"serve-small: non-finite logits at {i}")
        torch.testing.assert_close(a, b, **SERVE_SMALL_TOL)
        err = max(err, float((a - b).abs().max()))
    log(f"[serve-small] {sp['arch']} card vs cpu: prefill + {sp['steps']} "
        f"teacher-forced decode logits agree (rtol/atol 1e-4), max abs err "
        f"{err:.3e}")
    return err


def phase_serve_main():
    """The serving path through ServeEngine.generate at full size; launch
    counts read around exactly the measured generate call."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerationConfig, ServeEngine
    sv = SERVE
    cfg = dataclasses.replace(get_config(sv["arch"]), attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(sv["seed"])
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    eng = ServeEngine(cfg, params, device="cuda")
    del params
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up at the same shapes: cuBLAS handles, the allocator's pools
    eng.generate(prompts, GenerationConfig(max_new_tokens=2))
    gc = GenerationConfig(max_new_tokens=sv["new_tokens"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, gc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"ef_compress": 0, "decompress": 0, "adam_step": 0,
            "flash_attention": 0, "flash_attention_wgmma": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"serve launch counts {counts}, expected {want}")
    tokens = out["tokens"]
    if tuple(tokens.shape) != (sv["batch"], sv["new_tokens"]) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve: bad tokens {tokens.shape}")
    # the logits behind the first two tokens, outside the counted run
    with torch.inference_mode():
        logits, caches = T.prefill(eng.params, {"tokens": prompts}, cfg,
                                   cache_len=sv["prompt"] + 1)
        logits2, _ = T.decode_step(eng.params, {"tokens": tokens[:, :1]},
                                   caches, sv["prompt"], cfg)
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(logits2).all())
        first_same = float((logits[:, :cfg.vocab].float().argmax(-1)
                            == tokens[:, 0]).float().mean())
    del logits, logits2, caches
    if not finite:
        raise AssertionError("serve: non-finite logits")
    dec = out["decode_ms"]
    med = sorted(dec)[len(dec) // 2]
    n_tok = sv["batch"] * sv["new_tokens"]
    stats = dict(
        arch=sv["arch"], batch=sv["batch"], prompt=sv["prompt"],
        new_tokens=sv["new_tokens"], setup_s=setup_s,
        prefill_ms=out["prefill_ms"], decode_ms=dec,
        decode_ms_median=med, generate_wall_ms=wall_ms,
        tokens_per_s=n_tok / (wall_ms / 1e3),
        decode_tokens_per_s=sv["batch"] / (med / 1e3),
        prefill_tokens_per_s=sv["batch"] * sv["prompt"]
        / (out["prefill_ms"] / 1e3),
        peak_bytes=peak, first_token_matches_prefill_argmax=first_same)
    log(f"[serve-main] {sv['arch']} batch {sv['batch']} x prompt "
        f"{sv['prompt']}, {sv['new_tokens']} new tokens: prefill "
        f"{out['prefill_ms']:.1f} ms, decode median {med:.2f} ms/step "
        f"(min {min(dec):.2f}, max {max(dec):.2f}), generate wall "
        f"{wall_ms:.1f} ms, {stats['tokens_per_s']:.1f} tokens/s overall, "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s in decode, peak "
        f"memory {peak} bytes, launches {counts}, set-up {setup_s:.1f} s")
    return counts, stats, eng, prompts


def phase_serve_profile(eng, prompts) -> dict:
    """One prefill and one decode step of the serving model under
    torch.profiler: device time by kernel group and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    cfg, s = eng.cfg, prompts.shape[1]
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches = T.prefill(eng.params, {"tokens": prompts}, cfg,
                                       cache_len=s + 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["prefill"] = _device_breakdown(prof, wall_ms)
        tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
        T.decode_step(eng.params, {"tokens": tok}, caches, s, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            T.decode_step(eng.params, {"tokens": tok}, caches, s + 1, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["decode"] = _device_breakdown(prof, wall_ms)
    for what, r in out.items():
        _log_breakdown("serve-profile", what, r)
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
    del state
    torch.cuda.empty_cache()
    simt, wgmma = phase_flash()
    phase_serve_small()
    serve_counts, serve_stats, eng, prompts = phase_serve_main()
    serve_stats["profile"] = phase_serve_profile(eng, prompts)
    del eng, prompts
    torch.cuda.empty_cache()
    for e in entries:
        e["launches"] = counts[e["name"]]
    for e in (simt, wgmma):
        e["launches"] = serve_counts[e["name"]]
        entries.append(e)
    for e in entries:
        e["kernel_ms"] = e["ms"]
    print(json.dumps({"main_path": stats}))
    print(json.dumps({"serve_path": serve_stats}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
