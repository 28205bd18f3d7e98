"""Training entry point of the port: the optimizer family on the BERT encoder.

Runs on the card unless asked for the CPU (``--device cpu``); asking for
``cuda`` without a card raises.  One process is one dp rank: run it alone
(n_dp = 1), or under ``torchrun`` (NCCL on cuda, gloo on cpu), where the
mesh defaults to one dp axis over ``WORLD_SIZE`` ranks.

  python -m repro_torch.launch.train --arch bert-large --steps 6 \\
      --warmup-steps 3 --batch 16 --seq 128 --recipe onebit_lamb
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch bert-large
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch bert-large-smoke --mesh 2x2x1 --topology hier --pipeline 2 \\
      --overlap-bwd on

``--mesh`` takes the reference's grammar with a model axis of 1 (``N``,
``Nx1``, ``PxNx1``: P pods of N ranks).  ``--topology hier`` runs the
two-level exchange (on a one-pod mesh it is the flat one, and the printed
plan says ``flat/...``); ``--pipeline N`` splits the compressed exchange
into N block-aligned buckets (clamped to the alignment units);
``--overlap-bwd on`` issues each bucket's exchange from inside backward
on compressed steps that synchronise, with more than one bucket (every
other step runs serially; each step's record says which).  ``auto`` for
any of them is resolved by one joint search of the plan tuner
(``repro_torch.plan.autotune``) against ``--cluster`` (a link preset or
``measured:<comm_sweep.json>``) and ``--device-spec`` (a device preset,
default ``h100-sxm`` on cuda and ``cpu-host`` on cpu, or
``measured:<kernel_sweep.json>``); it prints the pick and the priced
table.  The recipes ``onebit_adam_autotopo`` and
``onebit_adam_pipelined`` set ``auto`` themselves.  The kernel axis has
no flag: a CUDA tensor takes the port's kernels, so the device spec
implies it.

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
the kernel launch counts of the run.  It prints the run's plan first.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
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
from repro_torch.launch.mesh import build_mesh, mesh_axes, pod_split
from repro_torch.models.transformer import init_params, leaf_shapes
from repro_torch.optim import WarmupSwitch, get_optimizer
from repro_torch.plan import autotune, get_cluster
from repro_torch.plan.schedules import (allreduce_schedule, flat_schedule,
                                        hier_schedule, needs_outer_ef)
from repro_torch.state import StateLayout, bucket_sizes_for
from repro_torch.state.checkpoint import load_train_state, save_train_state
from repro_torch.train.step import (flat_dim, init_train_state,
                                    overlap_applies, train_step)

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


def bwd_ready_fn(cfg, batch: int, seq: int, device, tp: int = 1):
    """``(ready_times_fn, t_bwd)``: a closure ``(bucket_offsets, d_pad)
    -> per-bucket ready seconds`` from the analytic reverse sweep
    (``analysis.model_math``), and the whole backward's seconds."""
    from repro_torch.analysis.model_math import (bwd_ready_times,
                                                 bwd_total_time)
    shape = InputShape("custom", seq, batch, "train")

    def fn(offsets, d_pad):
        return bwd_ready_times(offsets, d_pad, cfg, shape, device, tp)

    return fn, bwd_total_time(cfg, shape, device, tp)


def resolve_schedule(topology, pipeline, overlap_bwd,
                     cluster: str = "ethernet-10g", cfg=None,
                     dp_sizes=(1,), compressor: str = "onebit",
                     block_size: int = 4096, compressor_kwargs=None,
                     device_spec="h100-sxm", batch: int = 8,
                     seq: int = 128, verbose: bool = True) -> tuple:
    """``(topology, n_buckets, overlap, tuned)`` from the options'
    spellings: a topology name or ``"auto"``; ``"off"``, a bucket count
    or ``"auto"``; ``"off"``, ``"on"`` or ``"auto"``.

    The ``auto`` axes are resolved by one joint ``autotune`` search
    (``tuned`` is its TuneResult, else None): the mesh's dp sizes fix
    the pod split (the leading of two axes is the pod axis), ``cluster``
    the links, ``device_spec`` the compute roofline and the kernel axis;
    the compressor and block size are pinned.  Explicit values pin their
    axis.  Overlap candidates are priced on the analytic backward ready
    times for (``batch``, ``seq``) and charged only the exchange time
    exposed beyond backward."""
    if topology not in ("flat", "hier", "auto"):
        raise ValueError(f"topology must be 'flat', 'hier' or 'auto', got "
                         f"{topology!r}")
    if overlap_bwd not in ("off", "on", "auto"):
        raise ValueError(f"overlap_bwd must be 'off', 'on' or 'auto', got "
                         f"{overlap_bwd!r}")
    pipe_auto, topo_auto = pipeline == "auto", topology == "auto"
    ob_auto = overlap_bwd == "auto"
    n_buckets = 1 if pipeline in ("off", "auto") else int(pipeline)
    if n_buckets < 1:
        raise ValueError(f"pipeline must be 'off', 'auto' or a count >= 1, "
                         f"got {pipeline!r}")
    overlap = overlap_bwd == "on"
    if not (topo_auto or pipe_auto or ob_auto):
        return topology, n_buckets, overlap, None
    _, _, n_inner, n_outer = pod_split(mesh_axes(dp_sizes), dp_sizes)
    spec = get_cluster(cluster, n_inner=n_inner, n_outer=n_outer,
                       device=device_spec)
    d = flat_dim(cfg, n_inner * n_outer, block_size)
    if topo_auto:
        topos = ("flat", "hier") if n_outer > 1 else ("flat",)
    else:
        # hier on one pod runs flat: price what runs
        topos = (topology if topology != "hier" or n_outer > 1
                 else "flat",)
    # forced on still prices overlap off, so a serial pipeline keeps a
    # valid candidate
    overlap_opts = (False, True) if (ob_auto or overlap) else (False,)
    ready_fn, t_bwd = bwd_ready_fn(cfg, batch, seq, spec.device)
    tuned = autotune(spec, d, compressors=[compressor],
                     block_sizes=[block_size], topologies=topos,
                     compressor_kwargs=compressor_kwargs,
                     n_buckets_options=(1, 2, 4, 8) if pipe_auto
                     else (n_buckets,),
                     overlap_bwd_options=overlap_opts,
                     t_bwd=t_bwd, ready_times_fn=ready_fn)
    best = tuned.best
    if verbose:
        print(f"[auto-schedule] cluster={spec.name} "
              f"({n_outer} pod(s) x {n_inner} dp, "
              f"device={spec.device.name}): picked "
              f"{best.topology!r} x {best.n_buckets} bucket(s), "
              f"kernels={'cuda' if best.use_kernel else 'plain'}, "
              f"overlap-bwd={'on' if best.overlap_bwd else 'off'} "
              f"(t_exchange {best.t_exchange*1e3:.3f} ms, compute "
              f"{best.t_compute*1e3:.3f} ms, "
              f"DCI {best.dci_bytes_per_pod} B/pod)", flush=True)
        for c in tuned.table:
            if c.valid:
                print(f"    {c.topology:5s} buckets={c.n_buckets} "
                      f"kernels={'cuda' if c.use_kernel else 'plain':5s} "
                      f"overlap={'on' if c.overlap_bwd else 'off':3s} "
                      f"t={c.t_exchange*1e3:.3f} ms "
                      f"(compute {c.t_compute*1e3:.3f}) "
                      f"dci={c.dci_bytes_per_pod}", flush=True)
    out_nb = best.n_buckets if pipe_auto else n_buckets
    out_ob = best.overlap_bwd if ob_auto else overlap
    return (best.topology if topo_auto else topology, out_nb,
            out_ob and out_nb > 1, tuned)


def run_plans(optim, d_pad: int, dp_axes, dp_sizes, topology: str):
    """The (warmup, compressed) CommPlans this run executes, built on the
    host as the step builds them (``hier`` on one pod is flat)."""
    n_dp = math.prod(dp_sizes)
    axes = tuple(dp_axes) if n_dp > 1 else ()
    inner, outer, n_inner, n_outer = pod_split(axes, dp_sizes)
    comp = optim.compressor
    warm = allreduce_schedule(d_pad, n_dp, axes,
                              tier="cross" if n_outer > 1 else "intra")
    if topology == "hier" and n_outer > 1:
        plan = hier_schedule(comp, d_pad, n_inner, n_outer, inner, outer,
                             outer_ef=needs_outer_ef(comp))
    else:
        plan = flat_schedule(comp, d_pad, n_dp, axes)
    return warm, plan


def run(arch: str = "bert-base-smoke", recipe: str = "onebit_adam",
        steps: int = 100, warmup_steps: Optional[int] = None,
        batch: int = 8, seq: int = 128, block_size: int = 4096,
        lr: float = 1e-3, lr_warmup: int = 20, seed: int = 0,
        device: str = "cuda", verbose: bool = True,
        optimizer: Optional[str] = None, compressor: Optional[str] = None,
        ckpt: Optional[str] = None, resume: Optional[str] = None,
        stage_override: Optional[str] = None, mesh=None,
        topology: Optional[str] = None, pipeline=None,
        overlap_bwd: str = "off", cluster: str = "ethernet-10g",
        device_spec=None) -> dict:
    """Train until step ``steps``; returns ``{"history", "launches", "d",
    "d_pad", "state", "optimizer", "layout", "start_step",
    "checkpoint_s", "topology", "n_buckets", "overlap_bwd", "plan",
    "schedule"}`` (``checkpoint_s``: the seconds of the resume's load and
    the last save, host clock; ``plan``: the compressed exchange's plan
    name; ``schedule``: the tuner's pick, a ``plan.tune.Candidate``, when
    an axis was ``auto``, else None).

    ``warmup_steps`` is the manual T_w; ``None`` (or an ``auto`` recipe)
    selects the paper's Sec. 7.1 variance-ratio rule, as in the
    reference driver.  ``batch`` is the global batch, split over the dp
    ranks of an initialised process group.  ``mesh`` (default: one dp
    axis over the process group) is a ``--mesh`` spelling; ``topology``
    and ``pipeline`` default to the recipe's (``"flat"`` and ``"off"``
    but for the auto recipes).  ``auto`` values are resolved by the plan
    tuner (:func:`resolve_schedule`) against ``cluster`` and
    ``device_spec`` (a DeviceSpec, a preset name or
    ``measured:<path>``; default by ``device``).  ``resume``
    starts at the checkpoint's step; the compression-stage step count
    that drives ``sync_due`` resumes with it (manual T_w; the auto rule's
    monitor is not checkpointed, as in the reference)."""
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
    dpm = build_mesh(mesh if mesh is not None else str(n_dp), dev.type)
    topology, n_buckets, overlap, tuned = resolve_schedule(
        spec.topology if topology is None else topology,
        spec.pipeline if pipeline is None else pipeline, overlap_bwd,
        cluster=cluster, cfg=cfg, dp_sizes=dpm.sizes,
        compressor=spec.compressor, block_size=block_size,
        compressor_kwargs=spec.compressor_kwargs,
        device_spec=device_spec or ("cpu-host" if device == "cpu"
                                    else "h100-sxm"),
        batch=batch, seq=seq, verbose=verbose and rank == 0)
    dp_axes, pod_axes, n_inner, n_outer = pod_split(dpm.axes, dpm.sizes) \
        if n_dp > 1 else ((), (), 1, 1)
    if topology == "hier" and n_outer == 1:
        topology = "flat"           # one pod: the reference's step does so
    comp_kwargs = dict(spec.compressor_kwargs or {})
    comp_kwargs.setdefault("block_size", block_size)
    optim = get_optimizer(spec.optimizer, compressor=spec.compressor,
                          compressor_kwargs=comp_kwargs,
                          **(spec.optimizer_kwargs or {}))
    layout = "local" if optim.may_skip_sync else "replicated"
    hier = topology == "hier"
    d_pad = flat_dim(cfg, n_dp, block_size)
    # the bucket count the executor runs (clamped to the alignment units):
    # it fixes the EF slots' layout that checkpoints re-key
    n_buckets = len(bucket_sizes_for(d_pad, n_dp, block_size, n_buckets))
    warm_plan, comp_plan = run_plans(optim, d_pad, dpm.axes, dpm.sizes,
                                     topology)
    plan_name = comp_plan.name if n_buckets == 1 else \
        f"pipe({comp_plan.name})x{n_buckets}"
    if verbose and rank == 0:
        print(f"[plan] mesh {'x'.join(map(str, dpm.sizes))} "
              f"{dpm.axes} | warmup {warm_plan.name} | compressed "
              f"{plan_name} | overlap-bwd "
              f"{'on' if overlap and n_buckets > 1 else 'off'}"
              + (" (needs more than one bucket)"
                 if overlap and n_buckets == 1 else "")
              # the buckets of a pipelined plan move the same bytes
              + f" | wire bytes a rank and step: warmup "
              f"{warm_plan.wire_send_bytes():.0f}, compressed "
              f"{comp_plan.wire_send_bytes():.0f}", flush=True)
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    ts = init_train_state(cfg, params, optim, block_size, n_dp, dev,
                          layout=layout, n_inner=n_inner if hier else None)
    del params
    slots = optim.state_slots(layout)
    state_ctx = StateLayout(
        d=d_pad, n_dp=n_dp, n_srv=n_inner if hier else n_dp,
        n_outer=n_outer if hier else 1, n_segments=ts.segs.n,
        dp_sizes=dpm.sizes, tp=1)
    shapes = leaf_shapes(cfg)
    start_step, io_s = 0, {}
    if resume:
        t0 = time.perf_counter()
        (params, ts.opt), start_step = load_train_state(
            resume, params_from_flat(ts.x, shapes), ts.opt, slots=slots,
            ctx=state_ctx, n_buckets=n_buckets, block=block_size, rank=rank)
        with torch.no_grad():
            ts.x[:ts.d].copy_(flat_from_params(params))
        del params
        io_s["load"] = time.perf_counter() - t0
        if verbose and rank == 0:
            print(f"resumed from {resume} at step {start_step}", flush=True)

    def save(step: int) -> None:
        t0 = time.perf_counter()
        save_train_state(ckpt, params_from_flat(ts.x, shapes), ts.opt, step,
                         slots=slots, ctx=state_ctx, n_buckets=n_buckets,
                         block=block_size, dp_axes=dpm.axes if n_dp > 1
                         else ())
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
        over = overlap_applies(stage, sync, n_buckets, overlap)
        t0 = time.perf_counter()
        metrics = train_step(ts, optim, batch_t,
                             lr_schedule(step, lr, lr_warmup), stage,
                             dp_axes, sync=sync, pod_axes=pod_axes,
                             topology=topology,
                             n_buckets=n_buckets, overlap_bwd=overlap)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
        host = dict(zip(keys, vals.tolist()))   # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        if not stage_override:
            switch.observe(step, host)
        rec = {"step": step, "stage": stage, "sync": sync, "overlap": over,
               "stage0_in_bwd": ts.stage0_in_bwd, "ms": ms, **host}
        history.append(rec)
        if verbose and rank == 0:
            print(f"step {step:5d} [{stage:10s}{'' if sync else ' local'}"
                  f"{' overlap' if over else ''}] "
                  f"loss {rec['loss']:.4f} acc {rec['acc']:.3f} "
                  f"v_l1 {rec['v_l1']:.3e} ({ms:.1f} ms)", flush=True)
        if ckpt and (step + 1) % CKPT_EVERY == 0 and step + 1 < steps:
            save(step + 1)
    if ckpt:
        save(steps)
    return {"history": history, "launches": build.launch_counts(),
            "d": ts.d, "d_pad": d_pad, "state": ts, "optimizer": optim,
            "layout": layout, "start_step": start_step,
            "checkpoint_s": io_s, "topology": topology,
            "n_buckets": n_buckets, "overlap_bwd": overlap,
            "plan": plan_name,
            "schedule": tuned.best if tuned else None}


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
    ap.add_argument("--mesh", default=None,
                    help="N, Nx1 or PxNx1 (pods x data x model = 1); "
                         "default: one dp axis over WORLD_SIZE ranks")
    ap.add_argument("--topology", default=None,
                    choices=[None, "flat", "hier", "auto"],
                    help="hier = the two-level exchange (flat on one pod); "
                         "auto = the plan tuner picks per --cluster; "
                         "default: the recipe's")
    ap.add_argument("--pipeline", default=None,
                    help="off, a bucket count N (the pipelined exchange) "
                         "or auto; default: the recipe's")
    ap.add_argument("--overlap-bwd", default="off",
                    choices=["off", "on", "auto"],
                    help="issue each bucket's exchange from inside "
                         "backward (needs --pipeline > 1); auto = the "
                         "four-stream cost model decides")
    ap.add_argument("--cluster", default="ethernet-10g",
                    help="link preset the auto values are priced on "
                         "(repro_torch.plan.list_clusters()), or "
                         "measured:<comm_sweep.json>")
    ap.add_argument("--device-spec", default=None,
                    help="device preset of the compute pricing "
                         "(repro_torch.perf.list_devices()) or "
                         "measured:<kernel_sweep.json>; default h100-sxm "
                         "on cuda, cpu-host on cpu")
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
            ckpt=args.ckpt, resume=args.resume, stage_override=args.stage,
            mesh=args.mesh, topology=args.topology, pipeline=args.pipeline,
            overlap_bwd=args.overlap_bwd, cluster=args.cluster,
            device_spec=args.device_spec)
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
