"""Quickstart: the 1-bit Adam two-stage optimizer on a tiny LM, single
process, through the port's public API.

The port of ``examples/quickstart.py``:

  python -m repro_torch.examples.quickstart [--device cpu] [--steps 60]

Walks the paper's Algorithm 1: warmup with vanilla Adam, freeze the
variance when the ||v||_1 ratio stabilizes (the Sec. 7.1 auto rule), then
switch to error-compensated 1-bit compressed momentum SGD preconditioned
by the frozen variance.  On the card the warmup steps run the fused Adam
kernel and the compressed steps the 1-bit kernels.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import onebit_adam as OB
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.variance import VarianceMonitor
from repro_torch.data import SyntheticStream
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.train.step import (init_train_state, optimizer_from_config,
                                    train_step)

BLOCK = 512


def main(steps: int = 60, device: str = "cuda", verbose: bool = True):
    """Returns the run's history: (step, stage, loss) per step."""
    dev = resolve_device(device)
    # 1. pick an architecture (a registered id or its -smoke reduction)
    cfg = get_config("internlm2-1.8b-smoke")
    shape = InputShape("quickstart", seq_len=64, global_batch=8,
                       kind="train")

    # 2. the optimizer from its functional config, params, flat state
    ocfg = OB.OneBitAdamConfig(
        compression=CompressionConfig(block_size=BLOCK))
    opt = optimizer_from_config(ocfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    ts = init_train_state(cfg, params, opt, BLOCK, 1, dev)
    del params

    # 3. train: Adam until the variance stabilizes, then 1-bit momentum
    stream = SyntheticStream(cfg, shape, device=dev)
    monitor = VarianceMonitor(b2=0.97, lr_warmup_steps=10)
    frozen = False
    history = []
    for step in range(steps):
        stage = "compressed" if frozen else "warmup"
        m = train_step(ts, opt, stream.batch_at(step), 2e-3, stage)
        loss = float(m["loss"])
        history.append((step, stage, loss))
        if not frozen and monitor.observe(step, float(m["v_l1"])):
            frozen = True
            if verbose:
                print(f"--> variance frozen at step {step}; switching to "
                      f"1-bit compressed stage")
        if verbose and (step % 10 == 0 or step == steps - 1):
            print(f"step {step:3d} [{stage:10s}] loss {loss:.4f}")
    if verbose:
        print("done — loss decreased under 1-bit communication.")
    return history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
