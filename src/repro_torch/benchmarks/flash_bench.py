"""Time the flash-attention routes on the card beside their yardsticks.

Each case runs ``kernels.flash_attn.kernel.flash_attention`` (the route its
dtype and head dim take), the plain version ``ref.sdpa`` and PyTorch's
``scaled_dot_product_attention`` on the same causal inputs (made on the
card from ``--seed``), and reports: CUDA-event ms around one call (median
of 10), the device ms of the launch from torch.profiler (kernels whose
name holds ``flash_fwd``), the kernels the library call ran, the max abs
error against the plain version, and the bound
(``perf.device.kernel_bound``): the larger of the bytes (q, k, v read and
o written once) over the HBM rate and the causal operations 2*B*H*S^2*D
over the dtype's tensor-core peak (f32 at the TF32 rate). TF32 is off, so
f32 matmuls and SDPA run in full f32.  ``chip_smoke.py`` phase 7 times its
checked inputs through ``time_case``, which reads no profile.

  PYTHONPATH=src python -m repro_torch.benchmarks.flash_bench \
      --json flash.json
  PYTHONPATH=src python -m repro_torch.benchmarks.flash_bench \
      --cases f32:8,24,2048,128

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

import torch

CASES = ("f32:8,24,2048,128", "bf16:2,8,1024,512", "bf16:8,24,2048,128")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
# the peak that bounds each dtype's operations: f32 operands on the tensor
# cores run at the TF32 rate
PEAK_OF = {torch.float32: "tf32", torch.bfloat16: "bf16",
           torch.float16: "fp16"}


def parse_case(case: str) -> Tuple[torch.dtype, Tuple[int, int, int, int]]:
    """``"bf16:2,8,1024,512"`` -> (torch.bfloat16, (2, 8, 1024, 512))."""
    name, _, dims = case.partition(":")
    shape = tuple(int(x) for x in dims.split(","))
    if name not in DTYPES or len(shape) != 4:
        raise ValueError(f"flash_bench: case {case!r} is not "
                         "<f32|bf16|fp16>:B,H,S,D")
    return DTYPES[name], shape


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


def _device_kernels(fn) -> List[Tuple[str, float]]:
    """(name, device ms) of every kernel one call of ``fn`` launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def time_case(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """CUDA-event ms of one causal call on the card's q, k, v (B, H, S, D):
    the port's route, its plain version and SDPA; and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as K
    from repro_torch.kernels.flash_attn import ref as R
    from repro_torch.perf.device import kernel_bound
    b, h, s, d = q.shape
    bound_ms, bound_by = kernel_bound(4 * q.numel() * q.element_size(),
                                      2 * b * h * s * s * d,
                                      PEAK_OF[q.dtype])
    return dict(
        ms=time_ms(lambda: K.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: R.sdpa(q, k, v, causal=True), reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bound_ms=bound_ms, bound_by=bound_by)


def bench_case(dtype: torch.dtype, shape: Sequence[int], seed: int = 0
               ) -> dict:
    """One causal case on inputs made from ``seed``: its max abs error
    against the plain version, ``time_case``, and the device ms and names
    of the kernels the port's call and SDPA launch (torch.profiler)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as K
    from repro_torch.kernels.flash_attn import ref as R
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(tuple(shape), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    got = K.flash_attention(q, k, v, causal=True)
    want = R.sdpa(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    torch.cuda.empty_cache()
    kernel = _device_kernels(lambda: K.flash_attention(q, k, v, causal=True))
    library = _device_kernels(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    out = dict(dtype=str(dtype)[6:], shape=list(shape), causal=True,
               max_abs_err=err, **time_case(q, k, v),
               device_ms=sum(ms for n, ms in kernel if "flash_fwd" in n)
               or None,
               kernel_names=sorted({n[:100] for n, _ in kernel}),
               library_device_ms=sum(ms for _, ms in library),
               library_kernels=sorted({n[:100] for n, _ in library}))
    del q, k, v
    torch.cuda.empty_cache()
    return out


def run(cases: Sequence[str] = CASES, seed: int = 0) -> List[dict]:
    """Every case in turn; raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("flash_bench times the card's kernels: no CUDA "
                           "device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [bench_case(*parse_case(c), seed=seed) for c in cases]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    res = run(args.cases, args.seed)
    card = torch.cuda.get_device_name(0)
    for r in res:
        print(json.dumps(dict(r, card=card)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "cases": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
