"""Benchmark: Adam variance stabilisation (paper Fig. 2 + the Sec. 7.1
auto-warmup rule).

The port of ``benchmarks/variance_stability.py``.  Two measurements:

1. *Mechanism* (paper Fig. 2's regime): Adam (``core.adam``) on a
   stochastic quadratic with stationary gradient noise — ``v`` is an EMA
   of E[g^2], which CONVERGES as the iterate settles into the noise ball;
   the fused ``||v||_1`` growth ratio approaches 1 and the paper's
   ``||v_t||_1 / ||v_{t-Delta}||_1 >= 0.96`` rule (Delta = 1/(1-beta2))
   fires after LR warmup.  ``a`` and ``t_star`` come from the reference's
   numpy seed, the gradient noise from a seeded ``torch.Generator``.

2. *System wiring*: the same monitor driven by the real train step's
   ``v_l1`` metric (``train.step.train_step``, the registry ``onebit_adam``
   built from a ``OneBitAdamConfig`` by ``train.step.optimizer_from_config``;
   warmup steps, so on the card the fused Adam kernel) on the LM smoke
   model — checks the trigger plumbing end to end (on a 80-step toy LM
   ``v`` rises then decays as the model converges, unlike BERT's
   150K-step run, so only the firing is asserted there, not a plateau).
   ``system_phase`` takes any architecture and batch, so the same code
   runs at full BERT-Large.

``--segments N`` also splits the quadratic's ``v`` into N contiguous
segments and returns the late per-segment drift extrema
(``quad_seg_drift_late_max`` / ``_min``): every segment's variance must
have settled, not only the fused sum.

Not ported yet, waiting for the port of ``repro.obs`` (Slice E): the
event sink and ``--telemetry`` (per-step ``step``, ``transition`` and
``fidelity`` events), and ``--ledger`` (the BENCH record).

  python -m repro_torch.benchmarks.variance_stability [--segments 8] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import (AdamConfig, CompressionConfig,
                              OneBitAdamConfig, VarianceMonitor, adam_init,
                              adam_update)
from repro_torch.data import SyntheticStream
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.train.step import (init_train_state, optimizer_from_config,
                                    train_step)


def quadratic_phase(steps=400, d=1024, b2=0.97, lr_warmup=30, segments=0,
                    device="cpu") -> dict:
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, (d,)).astype(np.float32)
                         ).to(device)
    t_star = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)
                              ).to(device)
    x = torch.zeros(d, device=device)
    st = adam_init(d, device)
    cfg = AdamConfig(b2=b2)
    mon = VarianceMonitor(b2=b2, threshold=0.96, lr_warmup_steps=lr_warmup)
    gen = torch.Generator(device=device).manual_seed(0)
    v_hist, freeze_at = [], None
    # --segments: contiguous splits of v (stand-ins for param leaves)
    seg_off = (np.cumsum([0] + [s.size for s in
                                np.array_split(np.arange(d), segments)])
               if segments > 0 else None)
    v_seg_hist = []
    delta = mon.delta
    for t in range(steps):
        g = a * (x - t_star) + 0.3 * torch.randn(d, generator=gen,
                                                 device=device)
        lr = 5e-2 * min((t + 1) / lr_warmup, 1.0)
        x, st = adam_update(g, st, x, cfg, lr)
        v_abs = torch.abs(st.v)
        v = float(torch.sum(v_abs))
        v_hist.append(v)
        if segments > 0:
            va = v_abs.cpu().numpy()
            v_seg_hist.append([float(va[seg_off[i]:seg_off[i + 1]].sum())
                               for i in range(segments)])
        if mon.observe(t, v) and freeze_at is None:
            freeze_at = t
    out = {
        "freeze_step": freeze_at,
        "ratio_early": v_hist[lr_warmup + delta] / v_hist[lr_warmup],
        "ratio_late": v_hist[-1] / v_hist[-1 - delta],
        "delta": delta, "lr_warmup": lr_warmup,
    }
    if segments > 0:
        late = [s / p if p > 0 else 1.0 for s, p in
                zip(v_seg_hist[-1], v_seg_hist[-1 - delta])]
        out["n_segments"] = segments
        # per-segment version of ratio_late: EVERY segment's variance
        # must have stabilised, not just the fused sum (a drifting small
        # layer can hide inside a stable total)
        out["seg_drift_late_max"] = max(late)
        out["seg_drift_late_min"] = min(late)
    return out


def system_phase(steps=80, b2=0.97, lr_warmup=15, lr=1e-3,
                 arch="internlm2-1.8b-smoke", batch=8, seq=64, block=512,
                 device="cpu") -> dict:
    """Warmup steps of the train step under the auto rule's monitor;
    returns the firing step, the ``||v||_1`` ratio over Delta when it
    fired and at the end, and the first and last losses."""
    cfg = get_config(arch)
    opt = optimizer_from_config(OneBitAdamConfig(
        b2=b2, compression=CompressionConfig(block_size=block)))
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    ts = init_train_state(cfg, params, opt, block, 1, device)
    del params
    stream = SyntheticStream(cfg, InputShape("bench", seq, batch, "train"),
                             device=device)
    mon = VarianceMonitor(b2=b2, threshold=0.96, lr_warmup_steps=lr_warmup)
    freeze_at, ratio_at, losses = None, None, []
    for t in range(steps):
        m = train_step(ts, opt, stream.batch_at(t),
                       lr * min((t + 1) / lr_warmup, 1.0), "warmup")
        losses.append(float(m["loss"]))
        if mon.observe(t, float(m["v_l1"])) and freeze_at is None:
            freeze_at, ratio_at = t, mon.ratio
    return {"freeze_step": freeze_at, "lr_warmup": lr_warmup,
            "ratio_at_freeze": ratio_at, "ratio_last": mon.ratio,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses_finite": bool(np.isfinite(losses).all())}


def verdicts(quad: dict, sys_: dict):
    """(mechanism_ok, system_wiring_ok): the reference's rules."""
    ok_mech = (quad["freeze_step"] is not None
               and quad["freeze_step"] >= quad["lr_warmup"]
               and 0.96 <= quad["ratio_late"] <= 1.04)
    ok_sys = (sys_["freeze_step"] is not None
              and sys_["freeze_step"] >= sys_["lr_warmup"])
    return ok_mech, ok_sys


def run(verbose: bool = True, segments: int = 0,
        device: str = "cuda") -> dict:
    dev = resolve_device(device)
    quad = quadratic_phase(segments=segments, device=dev)
    sys_ = system_phase(device=dev)
    results = {f"quad_{k}": (round(v, 4) if isinstance(v, float) else v)
               for k, v in quad.items()}
    results.update({f"system_{k}": v for k, v in sys_.items()})
    ok_mech, ok_sys = verdicts(quad, sys_)
    results["mechanism_ok"] = ok_mech
    results["system_wiring_ok"] = ok_sys
    if verbose:
        print("== variance_stability (Fig. 2 / auto-warmup rule) ==")
        for k, v in results.items():
            print(f"  {k}: {v}")
        print(f"  [{'PASS' if ok_mech and ok_sys else 'FAIL'}] variance "
              f"ratio -> 1 under stationary noise "
              f"({quad['ratio_early']:.3f} -> {quad['ratio_late']:.3f}); "
              f"rule fires after LR warmup in both regimes")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--segments", type=int, default=0,
                    help="also report the late per-segment drift extrema "
                         "over N contiguous splits of v")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    run(segments=args.segments, device=args.device)
