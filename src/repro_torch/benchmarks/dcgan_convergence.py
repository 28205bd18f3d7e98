"""Benchmark: DCGAN training with 1-bit Adam (paper Sec. 7.3 / Fig. 8).

The port of ``benchmarks/dcgan_convergence.py``.  Trains the same small
DCGAN on identical synthetic image streams with Adam and with 2-stage
1-bit Adam (both G and D optimizers compressed after warmup, as in the
paper).  The paper's claim is qualitative — "1-bit Adam can achieve
almost the same training accuracy" — checked here as: (a) both runs stay
in the GAN equilibrium band (neither loss collapses), (b) the generator's
output statistics approach the data statistics for both optimizers
(within a 2.5x band: at this ~100K-param toy scale with 150 compressed
steps, the 1-bit quantization noise is proportionally much larger than in
the paper's full-size CelebA run, and shows up as extra generator drift —
the qualitative claim, equilibrium preserved under compression, is what
the scale supports).

Each network is one flat f32 vector in ``ravel_pytree`` order driven by
the port's ``core.onebit_adam`` (on the card the compressed steps take
the ``ef_compress`` and ``decompress`` kernels); TF32 is off for the run.
The stream and the initial weights are the port's own (numpy and
``torch.Generator``), so the verdicts are the port's claim.

  python -m repro_torch.benchmarks.dcgan_convergence [--device cpu]
"""
from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import (flat_from_params, params_from_flat,
                                 ravel_shapes)
from repro_torch.core import onebit_adam as OB
from repro_torch.core.compression import CompressionConfig, padded_length
from repro_torch.launch.train import resolve_device
from repro_torch.models.common import strict_f32
from repro_torch.models.dcgan import (d_loss, g_loss, generator,
                                      init_discriminator, init_generator,
                                      synthetic_faces)

STEPS = 300
WARMUP = 150
BLOCK = 64
BATCH = 64
Z = 32
LR = 2e-4


class _Opt:
    """Flat-vector 2-stage 1-bit Adam driver for one network."""

    def __init__(self, params: Dict[str, torch.Tensor], kind: str,
                 lr: float, device="cpu", warmup: Optional[int] = None):
        self.shapes = ravel_shapes(params)
        self.d = sum(math.prod(s) for _, s in self.shapes)
        self.dp = padded_length(self.d, 1, BLOCK)
        self.x = flat_from_params(params, self.dp).to(device)
        self.st = OB.init(self.dp, 1, device)
        # DCGAN's published optimizer setting: beta1 = 0.5 (Radford et al.)
        self.cfg = OB.OneBitAdamConfig(
            b1=0.5, compression=CompressionConfig(block_size=BLOCK))
        self.kind, self.lr = kind, lr
        # T_w: this module's WARMUP (read when the driver is made) unless
        # given
        self.warmup = WARMUP if warmup is None else warmup

    def params(self) -> Dict[str, torch.Tensor]:
        return params_from_flat(self.x[:self.d], self.shapes)

    def grad(self, loss_of: Callable[[Dict[str, torch.Tensor]],
                                     torch.Tensor]) -> torch.Tensor:
        """The gradient of ``loss_of(params)`` in x's padded layout."""
        leaf = self.x[:self.d].detach().requires_grad_()
        loss_of(params_from_flat(leaf, self.shapes)).backward()
        return F.pad(leaf.grad, (0, self.dp - self.d))

    @torch.no_grad()
    def step(self, g: torch.Tensor, t: int) -> None:
        """One update from the padded gradient ``g``; compressed from step
        ``self.warmup`` on, unless the kind is adam."""
        if self.kind == "adam" or t < self.warmup:
            self.x, self.st, _ = OB.warmup_update(g, self.st, self.x,
                                                  self.cfg, self.lr)
        else:
            self.x, self.st, _ = OB.compressed_update(g, self.st, self.x,
                                                      self.cfg, self.lr)


def _batch(t: int, device) -> tuple:
    rng = np.random.default_rng((1, t))
    z = torch.from_numpy(rng.standard_normal((BATCH, Z), dtype=np.float32))
    return z.to(device), synthetic_faces(rng, BATCH, device=device)


def _train(kind: str, steps: int = STEPS, device="cpu") -> Dict:
    gen = torch.Generator().manual_seed(0)
    og = _Opt(init_generator(gen, Z), kind, LR, device)
    od = _Opt(init_discriminator(gen), kind, LR, device)
    g_hist, d_hist = [], []
    for t in range(steps):
        z, real = _batch(t, device)
        pg_ = og.params()
        od.step(od.grad(lambda pd: d_loss(pd, pg_, real, z)), t)
        pd_ = od.params()
        og.step(og.grad(lambda pg: g_loss(pg, pd_, z)), t)
        if t % 10 == 0 or t == steps - 1:
            with torch.no_grad():
                g_hist.append(float(g_loss(og.params(), od.params(), z)))
                d_hist.append(float(d_loss(od.params(), og.params(), real,
                                           z)))
    # generator statistics vs data statistics
    with torch.no_grad():
        z = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (256, Z), dtype=np.float32)).to(device)
        fake = generator(og.params(), z)
        real = synthetic_faces(np.random.default_rng(3), 256, device=device)
        stat_err = float((fake.mean() - real.mean()).abs()
                         + (fake.std(correction=0)
                            - real.std(correction=0)).abs())
    return {"g_final": g_hist[-1], "d_final": d_hist[-1],
            "stat_err": stat_err}


def run(verbose: bool = True, device: str = "cuda") -> Dict:
    """Both runs' finals (rounded, as the reference's) and the two
    verdicts."""
    dev = resolve_device(device)
    with strict_f32():
        res = {k: _train(k, device=dev) for k in ("adam", "onebit")}
    out = {}
    for k, r in res.items():
        out.update({f"{k}_{kk}": round(v, 4) for kk, v in r.items()})
    # equilibrium band: neither D loss collapsed to 0 nor blew up
    ok_eq = all(0.02 < res[k]["d_final"] < 3.0 for k in res)
    ok_par = (res["onebit"]["stat_err"] < 2.5 * res["adam"]["stat_err"]
              and res["onebit"]["stat_err"] < 0.5)
    out["equilibrium_ok"] = ok_eq
    out["onebit_matches_adam"] = ok_par
    if verbose:
        print("== dcgan_convergence (Sec. 7.3 / Fig. 8) ==")
        for k, v in out.items():
            print(f"  {k}: {v}")
        print(f"  [{'PASS' if ok_eq and ok_par else 'FAIL'}] 1-bit Adam "
              f"holds the GAN equilibrium like Adam")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
