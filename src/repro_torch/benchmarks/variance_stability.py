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

With ``--telemetry DIR`` both phases emit the :mod:`repro_torch.obs`
event schema to ``DIR/variance_stability.jsonl``: per-step ``step``
events carrying ``v_l1`` (and the running variance ratio), a
``transition`` event where the rule fires, and with ``--segments`` a
``fidelity`` event a quadratic step (per-segment ``v_l1_seg`` and the
Delta-lagged ``v_drift``) — the event kind of ``launch.train --audit``,
so ``repro_torch.obs.report`` renders both alike.  ``--ledger PATH``
writes the result as a BENCH record (the late per-segment drift extrema
as ``fidelity_*`` metrics) for ``results/bench_compare.py``.

  python -m repro_torch.benchmarks.variance_stability [--segments 8] \\
      [--device cpu] [--telemetry DIR] [--ledger PATH]
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
from repro_torch.obs import NullSink, as_sink
from repro_torch.train.step import (init_train_state, optimizer_from_config,
                                    train_step)

SOURCE = "benchmarks/variance_stability"


def _observe(sink, mon: VarianceMonitor, t: int, v: float,
             stage: str) -> bool:
    """Feed the monitor and emit the matching step (and, on firing,
    transition) events; returns the monitor's frozen verdict."""
    fired_before = mon.freeze_step is not None
    frozen = mon.observe(t, v)
    fields = {"v_l1": v, "stage": stage}
    if mon.ratio is not None:
        fields["ratio"] = float(mon.ratio)
    sink.emit("step", step=t, **fields)
    if frozen and not fired_before and mon.freeze_step is not None:
        sink.emit("transition", step=t, kind="stage", frm="warmup",
                  to="compressed", mode="auto",
                  **({"ratio": float(mon.ratio)}
                     if mon.ratio is not None else {}))
    return frozen


def quadratic_phase(steps=400, d=1024, b2=0.97, lr_warmup=30, segments=0,
                    device="cpu", sink=NullSink()) -> dict:
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
            v_seg = [float(va[seg_off[i]:seg_off[i + 1]].sum())
                     for i in range(segments)]
            v_seg_hist.append(v_seg)
            fields = {"v_l1_seg": v_seg, "stage": "quadratic",
                      "source": SOURCE}
            if t >= delta:
                prev = v_seg_hist[t - delta]
                fields["v_drift"] = [s / p if p > 0 else 1.0
                                     for s, p in zip(v_seg, prev)]
                if v_hist[t - delta] > 0:
                    fields["v_ratio"] = v / v_hist[t - delta]
            sink.emit("fidelity", step=t, n_segments=segments, **fields)
        if _observe(sink, mon, t, v, "quadratic") and freeze_at is None:
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
                 device="cpu", sink=NullSink()) -> dict:
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
        if _observe(sink, mon, t, float(m["v_l1"]), "system") \
                and freeze_at is None:
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


def ledger_record(quad: dict, sys_: dict, segments: int) -> dict:
    """The BENCH record of one result (the reference's metrics)."""
    from repro_torch.obs.bench import bench_record
    metrics = {
        "freeze_step": float(quad["freeze_step"]
                             if quad["freeze_step"] is not None else -1),
        "ratio_early": float(quad["ratio_early"]),
        "ratio_late": float(quad["ratio_late"]),
        "system_freeze_step": float(sys_["freeze_step"]
                                    if sys_["freeze_step"] is not None
                                    else -1),
    }
    if segments > 0:
        # fidelity_* prefix: bench_compare treats drift in these as
        # structural (seeded deterministic math, not timing noise)
        metrics["fidelity_n_segments"] = float(segments)
        metrics["fidelity_seg_drift_late_max"] = \
            float(quad["seg_drift_late_max"])
        metrics["fidelity_seg_drift_late_min"] = \
            float(quad["seg_drift_late_min"])
    return bench_record("variance_stability", config="quadratic", mesh=[1],
                        pipeline=1, kernels=False, metrics=metrics)


def run(verbose: bool = True, segments: int = 0, device: str = "cuda",
        telemetry=None, ledger=None) -> dict:
    dev = resolve_device(device)
    with as_sink(telemetry, filename="variance_stability.jsonl") as sink:
        sink.emit("run_meta", optimizer="adam", compressor="none",
                  topology="flat", n_buckets=1, device=device,
                  source=SOURCE)
        quad = quadratic_phase(segments=segments, device=dev, sink=sink)
        sys_ = system_phase(device=dev, sink=sink)
    if telemetry and verbose:
        print(f"telemetry: {sink.n_events} events -> {sink.path}")
    results = {f"quad_{k}": (round(v, 4) if isinstance(v, float) else v)
               for k, v in quad.items()}
    results.update({f"system_{k}": v for k, v in sys_.items()})
    ok_mech, ok_sys = verdicts(quad, sys_)
    results["mechanism_ok"] = ok_mech
    results["system_wiring_ok"] = ok_sys
    if ledger:
        from repro_torch.obs.bench import write_ledger
        write_ledger(ledger, [ledger_record(quad, sys_, segments)],
                     meta={"source": SOURCE, "segments": segments,
                           "device": device})
        if verbose:
            print(f"ledger -> {ledger}")
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
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="emit the obs event schema to "
                         "DIR/variance_stability.jsonl (fold with python "
                         "-m repro_torch.obs.report)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="write a BENCH record of the result "
                         "(results/bench_compare.py compares two)")
    args = ap.parse_args()
    run(segments=args.segments, device=args.device,
        telemetry=args.telemetry, ledger=args.ledger)
