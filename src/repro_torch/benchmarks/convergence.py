"""Benchmark: sample-wise convergence parity (paper Fig. 1, Fig. 4, Fig. 6).

The port of ``benchmarks/convergence.py``.  Trains the same model on
identical synthetic streams and sweeps the FULL ``repro_torch.optim``
registry:

  * Adam (uncompressed baseline = BertAdam == any optimizer's warmup stage)
  * every registered two-stage optimizer (``onebit_adam``, ``zerone_adam``,
    ``onebit_lamb``) under its real 1-bit compressor AND under the
    ``identity`` compressor (the paper's "(32-bits)" ablation — for each
    optimizer this isolates the algorithm from the quantisation)
  * Adam (1-bit Naive) — EF-compressed gradient into live Adam
    (``core.momentum.naive_compressed_adam_update``, the strategy the
    paper shows FAILS, Fig. 1)
  * Momentum SGD (``core.momentum.update``, paper Sec. 7.2 baseline)

Registry runs go through ``train.step.train_step`` (on the card: the
fused Adam kernel in warmup, the 1-bit kernels in compressed steps), the
two manual baselines through the functional oracles on the flat vector.

Verdicts, per optimizer (the reference's):
  final(opt, identity) ~ final(Adam)   — the algorithm itself converges
  final(opt, onebit)   ~ final(Adam)   — and quantisation does not hurt
  final(naive)        >> final(1-bit Adam)
where a final is the mean of a curve's last 10 losses.

The defaults are the reference's toy sizes (the reduced internlm2-1.8b,
batch 8 x seq 64, 160 steps, T_w 40); every constant is a keyword of
``run`` and a flag here, so the same code runs at full BERT-Large:

  python -m repro_torch.benchmarks.convergence [--device cpu]
  python -m repro_torch.benchmarks.convergence --arch bert-large \\
      --batch 16 --seq 128 --steps 200 --warmup 40 --lr 1e-4 \\
      --optimizers onebit_adam --manual naive --out curves.json
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import flat_from_params
from repro_torch.core import momentum as M
from repro_torch.core.compression import CompressionConfig, padded_length
from repro_torch.data import SyntheticStream
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import (Transformer, flat_size,
                                            init_params, loss_fn)
from repro_torch.optim import get_optimizer, list_optimizers
from repro_torch.train.step import init_train_state, train_step

# LR/block chosen where Adam is stable but the naive compressed variant's
# corrupted variance estimate visibly degrades (the paper's Fig. 1 regime):
# at tiny LR the toy task is too easy to separate the optimizers.
STEPS = 160
WARMUP = 40
LR = 5e-3
BLOCK = 4096
MSGD_LR = 2e-2
ARCH = "internlm2-1.8b-smoke"
BATCH, SEQ = 8, 64
# identity-ablation parity band vs Adam (final-loss gap); LAMB is a
# different algorithm (layerwise trust ratios), so its band is wider
PARITY_TOL = {"onebit_adam": 0.25, "zerone_adam": 0.3, "onebit_lamb": 0.8}
MANUAL = ("naive", "msgd")
B2 = 0.999      # every Adam variant's, as in the reference


def _setup(arch, batch, seq, seed, dev):
    cfg = get_config(arch)
    stream = SyntheticStream(cfg, InputShape("bench", seq, batch, "train"),
                             seed=seed, device=dev)
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    return cfg, stream, params


def _train_registry(optimizer: str, compressor: str, steps: int = STEPS,
                    warmup: int = WARMUP, seed: int = 0, *,
                    arch: str = ARCH, batch: int = BATCH, seq: int = SEQ,
                    lr: float = LR, block: int = BLOCK, b2: float = B2,
                    device="cpu") -> List[float]:
    """Two-stage run of a registry optimizer; ``warmup >= steps`` gives
    the pure uncompressed-Adam baseline (the warmup stage of every
    optimizer IS BertAdam)."""
    cfg, stream, params = _setup(arch, batch, seq, seed, device)
    opt = get_optimizer(optimizer, compressor=compressor,
                        compressor_kwargs={"block_size": block}, b2=b2)
    ts = init_train_state(cfg, params, opt, block, 1, device)
    del params
    losses = []
    for t in range(steps):
        m = train_step(ts, opt, stream.batch_at(t), lr,
                       "warmup" if t < warmup else "compressed")
        losses.append(float(m["loss"]))
    return losses


def _train_manual(kind: str, steps: int = STEPS, seed: int = 0, *,
                  arch: str = ARCH, batch: int = BATCH, seq: int = SEQ,
                  lr: float = LR, msgd_lr: float = MSGD_LR,
                  block: int = BLOCK, b2: float = B2,
                  device="cpu") -> List[float]:
    """Flat-vector baselines driven manually (naive compressed / msgd)."""
    cfg, stream, params = _setup(arch, batch, seq, seed, device)
    d = flat_size(cfg)
    dp = padded_length(d, 1, block)
    x = flat_from_params(params, dp).to(device)
    del params
    g = torch.zeros_like(x)
    model = Transformer(cfg, x)     # its parameters are views of x
    model.bind_grads(g)
    comp = CompressionConfig(block_size=block)
    if kind == "naive":
        st = M.naive_init(dp, 1, device)

        def upd(x, st, g):
            return M.naive_compressed_adam_update(g, st, x, 0.9, b2, 1e-8,
                                                  lr, comp)
    elif kind == "msgd":
        st = M.init(dp, 1, device)
        mcfg = M.MomentumConfig(compression=CompressionConfig(
            kind="identity"))

        def upd(x, st, g):
            return M.update(g, st, x, mcfg, msgd_lr)
    else:
        raise ValueError(f"unknown manual baseline {kind!r}")
    losses = []
    for t in range(steps):
        g.zero_()
        loss, _ = loss_fn(model, stream.batch_at(t))
        loss.backward()             # accumulates into g
        with torch.no_grad():
            new_x, st = upd(x, st, g)
            x.copy_(new_x)
        losses.append(float(loss.detach()))
    return losses


def run(verbose: bool = True, optimizers: Optional[List[str]] = None, *,
        steps: int = STEPS, warmup: int = WARMUP, lr: float = LR,
        block: int = BLOCK, msgd_lr: float = MSGD_LR, arch: str = ARCH,
        batch: int = BATCH, seq: int = SEQ, manual: Sequence[str] = MANUAL,
        b2: float = B2, device: str = "cuda",
        curves: Optional[Dict[str, List[float]]] = None) -> Dict:
    """Every curve, the finals and the verdicts (``ok``: all of them);
    ``curves``, when given, receives every loss curve."""
    dev = resolve_device(device)
    optimizers = optimizers or list_optimizers()
    kw = dict(arch=arch, batch=batch, seq=seq, lr=lr, block=block, b2=b2,
              device=dev)
    got: Dict[str, List[float]] = {} if curves is None else curves
    got["adam"] = _train_registry("onebit_adam", "identity", steps=steps,
                                  warmup=steps, **kw)  # never leaves warmup
    for name in optimizers:
        for comp in ("onebit", "identity"):
            got[f"{name}:{comp}"] = _train_registry(name, comp, steps=steps,
                                                    warmup=warmup, **kw)
    for kind in manual:
        got[kind] = _train_manual(kind, steps=steps, msgd_lr=msgd_lr, **kw)

    final = {k: sum(v[-10:]) / 10 for k, v in got.items()}
    results: Dict = {f"final_{k.replace(':', '_')}": round(v, 4)
                     for k, v in final.items()}
    results["finite"] = all(math.isfinite(x) for v in got.values()
                            for x in v)
    allok = results["finite"]
    for name in optimizers:
        t = PARITY_TOL.get(name, 0.5)
        ok_id = final[f"{name}:identity"] < final["adam"] + t
        ok_1b = final[f"{name}:onebit"] < final["adam"] + t
        results[f"parity_{name}_identity_vs_adam"] = ok_id
        results[f"parity_{name}_onebit_vs_adam"] = ok_1b
        allok = allok and ok_id and ok_1b
    if "naive" in got:
        # the Fig.-1 qualitative ordering: naive compressed Adam (live v
        # from compressed grads) degrades where 1-bit Adam does not. The
        # gap widens with scale/steps; at toy scale assert a clear margin,
        # not the full-scale divergence.
        onebit_ref = final.get("onebit_adam:onebit", final["adam"])
        ok_naive = (final["naive"] > onebit_ref + 0.1
                    and final["naive"] > final["adam"] + 0.1)
        results["naive_fails"] = ok_naive
        allok = allok and ok_naive
    results["ok"] = allok
    if verbose:
        print(f"== convergence (Fig. 1 / Fig. 4 / Fig. 6): {arch}, batch "
              f"{batch} x seq {seq}, {steps} steps, T_w {warmup}, lr {lr}, "
              f"b2 {b2} ==")
        for k, v in results.items():
            print(f"  {k}: {v}")
        print(f"  [{'PASS' if allok else 'FAIL'}] every registered "
              f"optimizer ~ Adam (identity & 1-bit); naive compressed "
              f"Adam degrades")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--warmup", type=int, default=WARMUP,
                    help="T_w: compressed from this step on")
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--msgd-lr", type=float, default=MSGD_LR)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--b2", type=float, default=B2,
                    help="every Adam variant's second-moment decay")
    ap.add_argument("--optimizers", default=None,
                    help="comma-separated registry names (default: all)")
    ap.add_argument("--manual", default=",".join(MANUAL),
                    help="comma-separated manual baselines (naive, msgd; "
                         "empty for none)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="write the results and every loss curve here "
                         "(JSON)")
    args = ap.parse_args(argv)
    curves: Dict[str, List[float]] = {}
    res = run(optimizers=args.optimizers.split(",") if args.optimizers
              else None, steps=args.steps, warmup=args.warmup, lr=args.lr,
              block=args.block, msgd_lr=args.msgd_lr, arch=args.arch,
              b2=args.b2,
              batch=args.batch, seq=args.seq,
              manual=[k for k in args.manual.split(",") if k],
              device=args.device, curves=curves)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": res, "curves": curves}, f)
    return res


if __name__ == "__main__":
    main()
