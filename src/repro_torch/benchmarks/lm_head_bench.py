"""Time the LM-head cross-entropy kernels on the card beside their
yardsticks.

Each case is a head shape (T rows, d, V_l columns, the vocab below which
columns are kept) with a bf16 x and an f32 w made on the card from
``--seed``.  For the forward (w's split and the stats kernel) and the
backward (every row chunk's dS, dX and dW) apart, ``fwd`` and ``bwd``
hold, in ms (median of CUDA-event timings):

* ``ms``: the kernels (``kernel.forward`` / ``kernel.backward``);
* ``plain_ms``: the plain version (``ref.forward`` / ``ref.backward``) on
  the card;
* ``library_ms``: the f32 torch path the kernels replaced
  (``ref.plain_nll``: the materialised logits, reduced and differentiated
  by autograd);
* ``bound_ms`` (``bound_by``): the function's own f32 products (one
  forward; dX and dW backward; 2 T d V_l operations each) at the TF32
  rate, the f32 operands' tensor-core peak, or its least HBM traffic if
  that takes longer;
* ``split_floor_ms``: the bf16 products this design runs instead (3
  forward; 9 backward: the logits again, dX and dW) at the bf16 peak.

Beside them: ``kernels``, the device ms of each kernel of one forward and
one backward, from torch.profiler, by name; ``host_ms``, the host's ms
for one loss and its backward through the op (``ops.lm_head_xent``, as
the model calls it once a step), and ``library_host_ms`` the same through
the f32 path, each issued behind a queued ~0.1 s device sleep so the host
never waits for the device; ``peak_gb``, each path's peak memory above
its inputs.

TF32 is off, so the f32 products run in full f32 as in training.

  PYTHONPATH=src python -m repro_torch.benchmarks.lm_head_bench \
      --json lm_head.json

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.benchmarks.flash_bench import _device_kernels, time_ms

# (name, T, d, V_l, vocab): BERT-Large's head at 128 x 128 tokens;
# internlm2-1.8b's rank-0 half of the vocab at 8 x 2048 tokens
CASES = (("bert-large", 16384, 1024, 30528, 30522),
         ("internlm2-1.8b.tp2", 16384, 2048, 46272, 92544))
# device cycles of the sleep that keeps the device busy while the host
# issues the timed calls (~0.1 s at the H100's ~2 GHz)
SLEEP_CYCLES = 200_000_000


def bounds(t: int, d: int, v_l: int) -> Dict[str, Dict[str, object]]:
    """Per direction: the function's bound (its f32 products at the TF32
    rate, or its least HBM bytes) and this design's floor (its bf16
    products at the bf16 peak)."""
    from repro_torch.perf.device import H100_OPS_PER_S, kernel_bound
    unit = 2.0 * t * d * v_l
    x_b, w_b = 2 * t * d, 4 * d * v_l
    out = {}
    for key, products, split, n_bytes in (
            ("fwd", 1, 3, x_b + w_b + 12 * t),
            ("bwd", 2, 9, x_b + w_b + 4 * t * d + w_b + 16 * t)):
        ms, by = kernel_bound(n_bytes, products * unit, "tf32")
        out[key] = {"bound_ms": ms, "bound_by": by,
                    "split_floor_ms": split * unit / H100_OPS_PER_S["bf16"]
                    * 1e3}
    return out


def host_ms(fn: Callable[[], object], reps: int = 10) -> float:
    """Median host ms of ``fn`` issued behind a queued device sleep."""
    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times[2:])


def run_case(name: str, t: int, d: int, v_l: int, vocab: int, seed: int
             ) -> Dict[str, object]:
    from repro_torch.kernels.lm_head_xent import kernel as K
    from repro_torch.kernels.lm_head_xent import ops
    from repro_torch.kernels.lm_head_xent import ref as R
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, d, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(d, v_l, generator=gen, device=dev) * 0.02
    labels = torch.randint(0, min(vocab, v_l), (t,), generator=gen,
                           device=dev)
    mask = (torch.rand(t, generator=gen, device=dev) > 0.5).float()
    lab = labels.int()
    n_keep = min(vocab, v_l)
    a = mask / (mask.sum() * 30.0)
    b = -mask / mask.sum()
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()

    state = {}

    def fwd():
        state["out"] = K.forward(x, w, lab, n_keep)

    def bwd():
        m, _, _, saved = state["out"]
        K.backward(saved, lab, n_keep, m, a, b, d)

    def plain_fwd():
        state["plain"] = R.forward(x, w, lab, n_keep)

    def plain_bwd():
        R.backward(x, w, lab, n_keep, state["plain"][0], a, b)

    def library_fwd():
        nll = R.plain_nll(xg, wg, lab, n_keep)[0]
        state["loss"] = (nll * mask).sum() / mask.sum()

    def library_bwd():
        xg.grad = wg.grad = None
        state["loss"].backward(retain_graph=True)

    def op_step():
        m, s, ll = ops.lm_head_xent(xg, wg, labels, 0, vocab)
        xg.grad = wg.grad = None
        ((torch.log(s) + m - ll) * mask).sum().div(mask.sum()).backward()

    def library_step():
        library_fwd()
        library_bwd()

    out: Dict[str, object] = {"case": name, "T": t, "d": d, "V_l": v_l}
    fwd()
    plain_fwd()
    library_fwd()
    for key, (k_fn, p_fn, l_fn), bound in zip(
            ("fwd", "bwd"), ((fwd, plain_fwd, library_fwd),
                             (bwd, plain_bwd, library_bwd)),
            bounds(t, d, v_l).values()):
        out[key] = dict(ms=time_ms(k_fn, reps=5),
                        plain_ms=time_ms(p_fn, reps=3, warmup=1),
                        library_ms=time_ms(l_fn, reps=3, warmup=1), **bound)
    by_name: Dict[str, float] = defaultdict(float)
    for kname, ms in _device_kernels(lambda: (fwd(), bwd())):
        by_name[kname[:90]] += ms
    out["kernels"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    out["host_ms"] = host_ms(op_step)
    out["library_host_ms"] = host_ms(library_step)
    torch.cuda.synchronize()
    for key, fn in (("kernels", lambda: (fwd(), bwd())),
                    ("library", library_step)):
        state.clear()
        xg.grad = wg.grad = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        out.setdefault("peak_gb", {})[key] = \
            (torch.cuda.max_memory_allocated() - base) / 1e9
    state.clear()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lm_head_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = set(args.cases.split(","))
    rows: List[Dict[str, object]] = []
    for case in CASES:
        if case[0] in want:
            rows.append(run_case(*case, seed=args.seed))
            print(json.dumps(rows[-1]), flush=True)
    result = {"device": torch.cuda.get_device_name(0), "cases": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
