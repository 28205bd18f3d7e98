"""Spawned gloo ranks for tests/test_torch_layouts.py (torch and the port
only).  ``layouts_main``: rank ``r`` of ``world`` runs three scenarios on
its own data shard and saves what the test compares to ``rank<r>.npz``:

  * ``local``: 0/1 Adam through ``train_step`` under the local layout, 2
    warmup + 4 compressed steps with 0-bit steps between syncs: the flat
    parameters and the per-rank momentum after every step; then a
    checkpoint of that state (rank 0 writes the gathered per-rank slots)
    loaded back by each rank;
  * ``opt``: 1-bit LAMB's compressed ``update`` on the same per-rank
    gradients under zero1 and under replicated, 6 steps: this rank's
    master chunk and the replicated parameters' chunk;
  * ``step``: ``bert-large-smoke``, 2 replicated warmup steps, then one
    compressed step both replicated and (after ``seed_zero1``) under
    zero1, and 2 more zero1 steps.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import flat_from_params, params_from_flat
from repro_torch.data import SyntheticStream
from repro_torch.models.transformer import init_params, leaf_shapes
from repro_torch.optim import SegmentInfo, get_optimizer
from repro_torch.state import flat_layout
from repro_torch.state.checkpoint import load_train_state, save_train_state
from repro_torch.train.step import init_train_state, seed_zero1, train_step

ARCH = "bert-large-smoke"
BLOCK = 512
AXES = ("dp",)


def _ts(cfg, opt, layout, world):
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return init_train_state(cfg, params, opt, BLOCK, world, layout=layout)


def layouts_main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        out = {}
        cfg = get_config(ARCH)
        stream = SyntheticStream(cfg, InputShape("t", 32, 4, "train"),
                                 seed=0, shard=rank, n_shards=world)

        # local: 0/1 Adam with 0-bit steps
        opt = get_optimizer("zerone_adam", compressor="onebit",
                            compressor_kwargs={"block_size": BLOCK},
                            var_update_interval=2, sync_double_every=1,
                            sync_max_interval=2)
        ts = _ts(cfg, opt, "local", world)
        syncs = []
        for step in range(6):
            stage = "warmup" if step < 2 else "compressed"
            sync = stage == "warmup" or opt.sync_due(step - 2)
            train_step(ts, opt, stream.batch_at(step), 2e-3, stage, AXES,
                       sync=sync)
            syncs.append(sync)
            out[f"local_x{step}"] = ts.x.numpy().copy()
            out[f"local_m{step}"] = ts.opt.m.numpy().copy()
        out["local_syncs"] = np.array(syncs)
        out["local_v_step"] = int(ts.opt.v_step)
        slots = opt.state_slots("local")
        ctx = flat_layout(ts.x.shape[0], world, ts.segs.n)
        path = os.path.join(workdir, "local.npz")
        save_train_state(path, params_from_flat(ts.x, leaf_shapes(cfg)),
                         ts.opt, 6, slots=slots, ctx=ctx, n_buckets=1,
                         block=BLOCK, dp_axes=AXES)
        (params, st), step = load_train_state(
            path, params_from_flat(ts.x, leaf_shapes(cfg)), ts.opt,
            slots=slots, ctx=ctx, n_buckets=1, block=BLOCK, rank=rank)
        out["ckpt_path"] = path
        out["ckpt_round_trip"] = step == 6 and torch.equal(
            flat_from_params(params), ts.x[:ts.d]) and all(
            torch.equal(st[k], ts.opt[k]) for k in ts.opt)

        # opt: zero1 against replicated, 1-bit LAMB, same per-rank grads
        d = 8 * BLOCK * world
        segs = SegmentInfo((d // 2 + BLOCK, d // 2 - 2 * BLOCK, BLOCK))
        lamb = get_optimizer("onebit_lamb", compressor="onebit",
                             compressor_kwargs={"block_size": BLOCK})
        rng = np.random.default_rng(7)
        x0 = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
        m0 = torch.from_numpy(rng.standard_normal(d).astype(np.float32)
                              * 0.1)
        v0 = torch.from_numpy(np.abs(rng.standard_normal(d))
                              .astype(np.float32) + 0.1)
        chunk = d // world
        lo, hi = rank * chunk, (rank + 1) * chunk
        st_r = lamb.init_state(d, world, segs.n)._replace(m=m0, v=v0)
        st_z = lamb.init_state(d, world, segs.n, layout="zero1")._replace(
            m=m0, v_shard=v0[lo:hi].clone(), master_shard=x0[lo:hi].clone())
        x_r = x0
        grng = np.random.default_rng(100 + rank)
        for i in range(6):
            g = torch.from_numpy(grng.standard_normal(d).astype(np.float32)
                                 * 0.1)
            x_r, st_r, _ = lamb.update(g, st_r, 1e-2, x=x_r, dp_axes=AXES,
                                       segs=segs)
            xf, st_z, _ = lamb.update(g, st_z, 1e-2, dp_axes=AXES,
                                      segs=segs)
            out[f"opt_master{i}"] = st_z.master_shard.numpy().copy()
            out[f"opt_xr{i}"] = x_r[lo:hi].numpy().copy()
            out[f"opt_replica{i}"] = xf.float().numpy().copy()
            out[f"opt_scale{i}"] = st_z.scale.numpy().copy()
            out[f"opt_scale_r{i}"] = st_r.scale.numpy().copy()

        # step: seed_zero1 after a replicated warmup
        adam = get_optimizer("onebit_adam", compressor="onebit",
                             compressor_kwargs={"block_size": BLOCK})
        ts_r = _ts(cfg, adam, "replicated", world)
        for step in range(2):
            train_step(ts_r, adam, stream.batch_at(step), 2e-3, "warmup",
                       AXES)
        ts_z = _ts(cfg, adam, "replicated", world)
        ts_z.x.copy_(ts_r.x)
        ts_z.opt = ts_r.opt.map(torch.clone)
        seed_zero1(ts_z, adam, AXES)
        train_step(ts_r, adam, stream.batch_at(2), 2e-3, "compressed", AXES)
        train_step(ts_z, adam, stream.batch_at(2), 2e-3, "compressed", AXES)
        out["step_x_r"] = ts_r.x.numpy().copy()
        out["step_master"] = ts_z.opt.master_shard.numpy().copy()
        out["step_x_z0"] = ts_z.x.numpy().copy()
        losses = []
        for step in range(3, 5):
            losses.append(float(train_step(ts_z, adam, stream.batch_at(step),
                                           2e-3, "compressed", AXES)["loss"]))
        out["step_x_z"] = ts_z.x.numpy().copy()
        out["step_losses"] = np.array(losses)
        out["chunk"] = ts_z.opt.master_shard.shape[0]
        out["d"] = ts_z.d
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
