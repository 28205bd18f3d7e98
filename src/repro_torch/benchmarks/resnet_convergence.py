"""Benchmark: ResNet optimizer comparison (paper Sec. 7.2 + supplementary
Figs. 10/11).

The port of ``benchmarks/resnet_convergence.py``.  Trains a small
CIFAR-style ResNet with the paper's five optimizers on identical
synthetic streams:

  SGD, Momentum SGD, Adam, 1-bit Adam (13/200 epochs warmup in the paper;
  25% here), EF-Momentum-SGD (Zheng et al. 2019; 1-bit momentum, no Adam
  precondition), and DoubleSqueeze-style naive compressed Adam.

Paper's qualitative claims reproduced: 1-bit Adam ~ Adam; EF-momentum
converges (error feedback works for linear optimizers); naive compressed
Adam degrades.

Every run updates one flat f32 vector in ``ravel_pytree`` order through
the port's functional oracles (``core.onebit_adam``, ``core.momentum``);
on the card the compressed updates of ``onebit``, ``ef_msgd`` and
``naive`` take the ``ef_compress`` and ``decompress`` kernels.  TF32 is
off for the run.  The stream and the initial weights are the port's own
(numpy and ``torch.Generator``), so the verdicts are the port's claim.

  python -m repro_torch.benchmarks.resnet_convergence [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import (flat_from_params, params_from_flat,
                                 ravel_shapes)
from repro_torch.core import momentum as M
from repro_torch.core import onebit_adam as OB
from repro_torch.core.compression import CompressionConfig, padded_length
from repro_torch.launch.train import resolve_device
from repro_torch.models.common import strict_f32
from repro_torch.models.resnet import (WIDTHS, init_resnet, resnet_loss,
                                       synthetic_cifar)

STEPS = 150
WARMUP = 40
BLOCK = 256
BATCH = 64
SIZE = 16
KINDS = ("adam", "onebit", "msgd", "ef_msgd", "naive", "sgd")
LRS = {"sgd": 1e-1, "msgd": 5e-2, "adam": 2e-3, "onebit": 2e-3,
       "ef_msgd": 5e-2, "naive": 2e-3}

Shapes = List[Tuple[str, Tuple[int, ...]]]
Update = Callable[[torch.Tensor, object, torch.Tensor, int],
                  Tuple[torch.Tensor, object]]


def _stream(step: int, batch: int = BATCH, size: int = SIZE, device="cpu"
            ) -> Dict[str, torch.Tensor]:
    return synthetic_cifar(np.random.default_rng((0, step)), batch,
                           size=size, device=device)


def flat_problem(params: Dict[str, torch.Tensor], block: int = BLOCK
                 ) -> Tuple[torch.Tensor, int, Shapes]:
    """(x zero-padded to a multiple of ``block``, d, the leaves' (path,
    shape) in ravel order)."""
    shapes = ravel_shapes(params)
    d = sum(math.prod(s) for _, s in shapes)
    return flat_from_params(params, padded_length(d, 1, block)), d, shapes


def loss_and_grad(x: torch.Tensor, d: int, shapes: Shapes,
                  batch: Dict[str, torch.Tensor],
                  widths: Sequence[int] = WIDTHS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, its gradient in x's padded layout) at the weights ``x``."""
    leaf = x[:d].detach().requires_grad_()
    loss, _ = resnet_loss(params_from_flat(leaf, shapes), batch, widths)
    loss.backward()
    return loss.detach(), F.pad(leaf.grad, (0, x.shape[0] - d))


def make_update(kind: str, dp: int, device, warmup: Optional[int] = None,
                block: int = BLOCK) -> Tuple[object, Update]:
    """(initial state, ``update(x, state, g, t) -> (x, state)``) of one of
    the six optimizers, as the reference's ``_train`` dispatches them;
    ``warmup`` defaults to this module's ``WARMUP`` at call time."""
    t_w = WARMUP if warmup is None else warmup
    lr = LRS[kind]
    comp = CompressionConfig(block_size=block)
    if kind in ("adam", "onebit"):
        ocfg = OB.OneBitAdamConfig(compression=comp)

        def update(x, st, g, t):
            fn = OB.warmup_update if kind == "adam" or t < t_w \
                else OB.compressed_update
            x, st, _ = fn(g, st, x, ocfg, lr)
            return x, st
        return OB.init(dp, 1, device), update
    if kind in ("msgd", "ef_msgd"):
        mcfg = M.MomentumConfig(compression=(
            comp if kind == "ef_msgd"
            else CompressionConfig(kind="identity", block_size=block)))
        return M.init(dp, 1, device), \
            lambda x, st, g, t: M.update(g, st, x, mcfg, lr)
    if kind == "naive":
        return M.naive_init(dp, 1, device), \
            lambda x, st, g, t: M.naive_compressed_adam_update(
                g, st, x, 0.9, 0.999, 1e-8, lr, comp)
    if kind == "sgd":
        return None, lambda x, st, g, t: (x - lr * g, st)
    raise ValueError(f"unknown optimizer kind {kind!r}")


def train(kind: str, steps: int = STEPS, *, warmup: Optional[int] = None,
          widths: Sequence[int] = WIDTHS, size: int = SIZE,
          batch: int = BATCH, device="cpu", params=None,
          batches: Optional[Callable[[int], Dict]] = None,
          walls: Optional[List[float]] = None) -> List[float]:
    """One run's loss curve.  ``params`` (default: ``init_resnet`` from
    seed 1) and ``batches`` (``t -> batch``; default: the port's stream,
    seeded (0, t)) let a caller feed other inputs; ``walls`` receives each
    step's host-clock ms (the loss read ends the step)."""
    dev = torch.device(device)
    if params is None:
        params = init_resnet(torch.Generator().manual_seed(1), widths)
    x, d, shapes = flat_problem({k: v.to(dev) for k, v in params.items()})
    st, update = make_update(kind, x.shape[0], dev, warmup)
    losses = []
    for t in range(steps):
        t0 = time.perf_counter()
        b = batches(t) if batches is not None else \
            _stream(t, batch, size, dev)
        loss, g = loss_and_grad(x, d, shapes, b, widths)
        with torch.no_grad():
            x, st = update(x, st, g, t)
        losses.append(float(loss))
        if walls is not None:
            walls.append((time.perf_counter() - t0) * 1e3)
    return losses


def verdicts(finals: Dict[str, float], initials: Dict[str, float]) -> Dict:
    """The reference's three criteria (short-horizon analogues of the
    paper's 200-epoch runs): 1-bit Adam tracks Adam; EF momentum
    CONVERGES (at 150 steps the EF transient is still visible, so
    convergence, not parity); naive compressed Adam is never better than
    1-bit Adam."""
    return {"onebit_matches_adam": finals["onebit"] < finals["adam"] + 0.3,
            "ef_momentum_converges": (finals["ef_msgd"]
                                      < 0.3 * initials["ef_msgd"]),
            "naive_not_better": finals["naive"] >= finals["onebit"]}


def run(verbose: bool = True, device: str = "cuda") -> Dict:
    """The six curves' finals (mean of the last 10 losses) and the
    verdicts (``ok``: all three)."""
    dev = resolve_device(device)
    with strict_f32():
        got = {k: train(k, device=dev) for k in KINDS}
    finals = {k: sum(c[-10:]) / 10 for k, c in got.items()}
    results: Dict = {f"final_{k}": round(v, 4) for k, v in finals.items()}
    results["finite"] = bool(np.isfinite([x for c in got.values()
                                          for x in c]).all())
    verdict = verdicts(finals, {k: c[0] for k, c in got.items()})
    results.update(verdict)
    ok = results["finite"] and all(verdict.values())
    results["ok"] = ok
    if verbose:
        print("== resnet_convergence (Sec. 7.2 / supp Figs. 10-11) ==")
        for k, v in results.items():
            print(f"  {k}: {v}")
        print(f"  [{'PASS' if ok else 'FAIL'}] optimizer ordering matches "
              f"the paper")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
