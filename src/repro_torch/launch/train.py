"""Training entry point of the port: the optimizer family on the BERT encoder.

Runs on the card unless asked for the CPU (``--device cpu``); asking for
``cuda`` without a card raises.  One process is one dp rank: run it alone
(n_dp = 1), or under ``torchrun`` (NCCL on cuda, gloo on cpu).

  python -m repro_torch.launch.train --arch bert-large --steps 6 \\
      --warmup-steps 3 --batch 16 --seq 128 --recipe onebit_lamb
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch bert-large

A recipe (``--recipe``, ``repro_torch.configs.list_optim_recipes``) names
the optimizer, the compressor, their keyword arguments and the warmup
switch; ``--optimizer`` / ``--compressor`` override its names.  The state
layout follows the optimizer: ``local`` when it may skip syncs (0/1
Adam's 0-bit steps; ``sync_due`` is asked once per compression-stage
step), else ``replicated``.  ``--ckpt PATH`` saves the parameters and
optimizer state every 100 steps and at the end, in the reference's
archive format; ``--resume PATH`` continues from one at its step;
``--stage`` forces every step's stage, synchronises every step and
leaves the warmup switch unfed, as the reference's does.

``run(...)`` is the entry point the tests and ``chip_smoke.py`` drive: it
returns the per-step history (loss, stage, sync, metrics, step time) and
the kernel launch counts of the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (get_config, get_optim_recipe,
                                  list_optim_recipes)
from repro_torch.configs.base import InputShape
from repro_torch.convert import flat_from_params, params_from_flat
from repro_torch.data import SyntheticStream
from repro_torch.kernels import build
from repro_torch.models.transformer import init_params, leaf_shapes
from repro_torch.optim import WarmupSwitch, get_optimizer
from repro_torch.state import flat_layout
from repro_torch.state.checkpoint import load_train_state, save_train_state
from repro_torch.train.step import flat_dim, init_train_state, train_step

CKPT_EVERY = 100


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
        device: str = "cuda", verbose: bool = True,
        optimizer: Optional[str] = None, compressor: Optional[str] = None,
        ckpt: Optional[str] = None, resume: Optional[str] = None,
        stage_override: Optional[str] = None) -> dict:
    """Train until step ``steps``; returns ``{"history", "launches", "d",
    "d_pad", "state", "optimizer", "layout", "start_step",
    "checkpoint_s"}`` (the seconds of the resume's load and the last
    save, host clock).

    ``warmup_steps`` is the manual T_w; ``None`` (or an ``auto`` recipe)
    selects the paper's Sec. 7.1 variance-ratio rule, as in the
    reference driver.  ``batch`` is the global batch, split over the dp
    ranks of an initialised process group.  ``resume`` starts at the
    checkpoint's step; the compression-stage step count that drives
    ``sync_due`` resumes with it (manual T_w; the auto rule's monitor is
    not checkpointed, as in the reference)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = get_optim_recipe(recipe)
    if optimizer:
        spec = dataclasses.replace(spec, optimizer=optimizer)
    if compressor:
        spec = dataclasses.replace(spec, compressor=compressor)
    spec = dataclasses.replace(spec, block_size=block_size)
    n_dp = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp_axes = ("dp",) if n_dp > 1 else ()

    comp_kwargs = dict(spec.compressor_kwargs or {})
    comp_kwargs.setdefault("block_size", block_size)
    optim = get_optimizer(spec.optimizer, compressor=spec.compressor,
                          compressor_kwargs=comp_kwargs,
                          **(spec.optimizer_kwargs or {}))
    layout = "local" if optim.may_skip_sync else "replicated"
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    ts = init_train_state(cfg, params, optim, block_size, n_dp, dev,
                          layout=layout)
    del params
    slots = optim.state_slots(layout)
    state_ctx = flat_layout(ts.x.shape[0], n_dp, ts.segs.n)
    shapes = leaf_shapes(cfg)
    start_step, io_s = 0, {}
    if resume:
        t0 = time.perf_counter()
        (params, ts.opt), start_step = load_train_state(
            resume, params_from_flat(ts.x, shapes), ts.opt, slots=slots,
            ctx=state_ctx, n_buckets=1, block=block_size, rank=rank)
        with torch.no_grad():
            ts.x[:ts.d].copy_(flat_from_params(params))
        del params
        io_s["load"] = time.perf_counter() - t0
        if verbose and rank == 0:
            print(f"resumed from {resume} at step {start_step}", flush=True)

    def save(step: int) -> None:
        t0 = time.perf_counter()
        save_train_state(ckpt, params_from_flat(ts.x, shapes), ts.opt, step,
                         slots=slots, ctx=state_ctx, n_buckets=1,
                         block=block_size, dp_axes=dp_axes)
        io_s["save"] = time.perf_counter() - t0

    stream = SyntheticStream(cfg, InputShape("custom", seq, batch, "train"),
                             seed=seed, shard=rank, n_shards=n_dp,
                             device=dev)
    manual = warmup_steps is not None and spec.switch_mode == "steps"
    switch = WarmupSwitch(
        mode="steps" if manual else "auto",
        warmup_steps=warmup_steps if warmup_steps is not None else 0,
        b2=optim.b2, threshold=spec.var_freeze_threshold,
        lr_warmup_steps=lr_warmup)
    # compression-stage step index (drives sync_due)
    comp_step = sum(switch.compressed(s) for s in range(start_step)) \
        if manual else 0

    build.reset_launch_counts()
    history = []
    for step in range(start_step, steps):
        if stage_override:
            stage, sync = stage_override, True
        else:
            compressed = switch.compressed(step)
            stage = "compressed" if compressed else "warmup"
            sync = optim.sync_due(comp_step) if compressed else True
            comp_step += compressed
        batch_t = stream.batch_at(step)
        t0 = time.perf_counter()
        metrics = train_step(ts, optim, batch_t,
                             lr_schedule(step, lr, lr_warmup), stage,
                             dp_axes, sync=sync)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
        host = dict(zip(keys, vals.tolist()))   # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        if not stage_override:
            switch.observe(step, host)
        rec = {"step": step, "stage": stage, "sync": sync, "ms": ms, **host}
        history.append(rec)
        if verbose and rank == 0:
            print(f"step {step:5d} [{stage:10s}{'' if sync else ' local'}] "
                  f"loss {rec['loss']:.4f} acc {rec['acc']:.3f} "
                  f"v_l1 {rec['v_l1']:.3e} ({ms:.1f} ms)", flush=True)
        if ckpt and (step + 1) % CKPT_EVERY == 0 and step + 1 < steps:
            save(step + 1)
    if ckpt:
        save(steps)
    return {"history": history, "launches": build.launch_counts(),
            "d": ts.d, "d_pad": flat_dim(cfg, n_dp, block_size),
            "state": ts, "optimizer": optim, "layout": layout,
            "start_step": start_step, "checkpoint_s": io_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="bert-base-smoke")
    ap.add_argument("--recipe", default="onebit_adam",
                    choices=list_optim_recipes())
    ap.add_argument("--optimizer", default=None,
                    help="override the recipe's optimizer (registry name)")
    ap.add_argument("--compressor", default=None,
                    help="override the recipe's compressor (registry name)")
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
    ap.add_argument("--ckpt", default=None,
                    help="save parameters and optimizer state here (npz)")
    ap.add_argument("--resume", default=None,
                    help="continue from this checkpoint at its step")
    ap.add_argument("--stage", default=None,
                    choices=[None, "warmup", "compressed"],
                    help="force every step's stage")
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
            lr_warmup=args.lr_warmup, seed=args.seed, device=args.device,
            optimizer=args.optimizer, compressor=args.compressor,
            ckpt=args.ckpt, resume=args.resume, stage_override=args.stage)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
