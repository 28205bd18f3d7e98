"""Training driver of the port: 1-bit Adam on the BERT encoder.

Runs on the card unless asked for the CPU (``--device cpu``); asking for
``cuda`` without a card raises.  One process is one dp rank: run it alone
(n_dp = 1), or under ``torchrun`` (NCCL on cuda, gloo on cpu).

  python -m repro_torch.launch.train --arch bert-large --steps 6 \\
      --warmup-steps 3 --batch 16 --seq 128
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch bert-large

``run(...)`` is the entry point the tests and ``chip_smoke.py`` drive: it
returns the per-step history (loss, stage, metrics, step time) and the
kernel launch counts of the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_optim_recipe
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticStream
from repro_torch.kernels import build
from repro_torch.models.transformer import init_params
from repro_torch.optim import WarmupSwitch, get_optimizer
from repro_torch.train.step import flat_dim, init_train_state, train_step


def lr_schedule(step: int, base_lr: float, lr_warmup: int,
                decay: float = 0.99, decay_every: int = 520) -> float:
    """The paper's BERT schedule: linear warmup then step decay."""
    if step < lr_warmup:
        return base_lr * (step + 1) / max(lr_warmup, 1)
    return base_lr * (decay ** ((step - lr_warmup) // decay_every))


def resolve_device(device: str) -> torch.device:
    """``cuda`` (this rank's card) or ``cpu``; cuda without a card raises."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def run(arch: str = "bert-base-smoke", recipe: str = "onebit_adam",
        steps: int = 100, warmup_steps: Optional[int] = None,
        batch: int = 8, seq: int = 128, block_size: int = 4096,
        lr: float = 1e-3, lr_warmup: int = 20, seed: int = 0,
        device: str = "cuda", verbose: bool = True) -> dict:
    """Train ``steps`` steps; returns ``{"history", "launches", "d",
    "d_pad", "state"}``.

    ``warmup_steps`` is the manual T_w; ``None`` (or an ``auto`` recipe)
    selects the paper's Sec. 7.1 variance-ratio rule, as in the
    reference driver.  ``batch`` is the global batch, split over the dp
    ranks of an initialised process group."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = dataclasses.replace(get_optim_recipe(recipe),
                               block_size=block_size)
    n_dp = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp_axes = ("dp",) if n_dp > 1 else ()

    optimizer = get_optimizer(spec.optimizer, compressor=spec.compressor,
                              compressor_kwargs={"block_size": block_size})
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    ts = init_train_state(cfg, params, optimizer, block_size, n_dp, dev)
    del params
    stream = SyntheticStream(cfg, InputShape("custom", seq, batch, "train"),
                             seed=seed, shard=rank, n_shards=n_dp,
                             device=dev)
    manual = warmup_steps is not None and spec.switch_mode == "steps"
    switch = WarmupSwitch(
        mode="steps" if manual else "auto",
        warmup_steps=warmup_steps if warmup_steps is not None else 0,
        b2=optimizer.b2, threshold=spec.var_freeze_threshold,
        lr_warmup_steps=lr_warmup)

    build.reset_launch_counts()
    history = []
    for step in range(steps):
        stage = "compressed" if switch.compressed(step) else "warmup"
        batch_t = stream.batch_at(step)
        t0 = time.perf_counter()
        metrics = train_step(ts, optimizer, batch_t,
                             lr_schedule(step, lr, lr_warmup), stage,
                             dp_axes)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
        host = dict(zip(keys, vals.tolist()))   # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        switch.observe(step, host)
        rec = {"step": step, "stage": stage, "ms": ms, **host}
        history.append(rec)
        if verbose and rank == 0:
            print(f"step {step:5d} [{stage:10s}] loss {rec['loss']:.4f} "
                  f"acc {rec['acc']:.3f} v_l1 {rec['v_l1']:.3e} "
                  f"({ms:.1f} ms)", flush=True)
    return {"history": history, "launches": build.launch_counts(),
            "d": ts.d, "d_pad": flat_dim(cfg, n_dp, block_size),
            "state": ts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="bert-base-smoke")
    ap.add_argument("--recipe", default="onebit_adam",
                    choices=["onebit_adam"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="manual T_w (compressed from this step on)")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split over the dp ranks")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:   # under torchrun: it provides MASTER_ADDR/PORT and RANK
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        run(arch=args.arch, recipe=args.recipe, steps=args.steps,
            warmup_steps=args.warmup_steps, batch=args.batch, seq=args.seq,
            block_size=args.block_size, lr=args.lr,
            lr_warmup=args.lr_warmup, seed=args.seed, device=args.device)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
