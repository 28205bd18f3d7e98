"""Spawned ranks for the hierarchical / pipelined / backward-overlap tests
(tests/test_torch_hier.py, test_torch_overlap.py, test_torch_pipeline.py
and the card tests of test_torch_cuda.py).  They import torch and the
port only.

``exchange_main``: on a 2 x 2 (pod x data) mesh, three chained
hierarchical exchanges of ``inputs.npz`` per compressor (``onebit``,
``topk`` with the outer EF slots, ``identity``), serial and over
``NB`` buckets, from zero EF slots; saves every step's output and slots to
``<backend><rank>.npz``, and whether top-k without the outer slots raised.

``steps_main``: a few ``train_step``s per entry of ``runs.json`` (arch,
mesh, topology, buckets, overlap, accumulation, zero1, and optionally the
optimizer, its keyword arguments and the ``local`` layout, whose
compression-stage steps synchronise as ``sync_due`` says); saves losses,
step wall ms, the kernel launches of every step, the syncs, and the
parameters and state to ``steps<rank>.npz`` (with ``digest``: their
SHA-256 instead, for full-size models).

``layouts_main``: per entry of ``runs.json``, the optimizer's own
warmup and compressed updates (the calls ``train_step`` makes) under the
``local`` layout or with zero1 compressed steps, on a 2 x 2 mesh, fed
seeded gradients whose dp sums are exact in f32 (multiples of 2^-14 below
1/16 in magnitude), so the warmup all-reduce gives the same bits whatever
order a backend sums in; ``on_card`` puts a gloo rank's tensors on its
card; saves every step's parameters and state to
``layouts_<backend><rank>.npz``.

``run_main``: the port's ``run`` per entry of ``runs.json`` (checkpoint
and resume included, ``auto`` schedule axes too); saves each run's losses,
plan name, stage 0s issued inside backward, parameters and state to
``run<rank>.npz`` (with ``digest``: SHA-256s of the parameters and
state), and the checkpoint's save and load seconds.
"""
import hashlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

COMPRESSORS = ("onebit", "topk", "identity")
EXCHANGE_STEPS = 3
NB = 3


def _init(rank: int, world: int, workdir: str, backend: str, tag: str,
          on_card: bool = None):
    """This rank's device (its card under NCCL, or with ``on_card``) and
    the process group."""
    if on_card if on_card is not None else backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        os.environ["LOCAL_RANK"] = str(rank)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)    # the ranks share the host's cores
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(
            workdir, f"rendezvous_{tag}_{backend}"),
        rank=rank, world_size=world)
    return dev


def hier_errs(d: int, n_inner: int, n_outer: int, dev, outer=True):
    errs = {"worker": torch.zeros(d, device=dev),
            "server": torch.zeros(d // n_inner, device=dev)}
    if outer:
        errs["outer"] = torch.zeros(d // n_inner, device=dev)
        errs["outer_ag"] = torch.zeros(d // (n_inner * n_outer), device=dev)
    return errs


def exchange_main(rank: int, world: int, workdir: str, block: int,
                  backend: str) -> None:
    from repro_torch.core.comm import compressed_exchange
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim.compressors import get_compressor
    dev = _init(rank, world, workdir, backend, "exchange")
    try:
        mesh = build_mesh("2x2x1")
        assert mesh.axes == ("pod", "data")
        assert dist.get_rank(mesh.groups[("pod",)]) == rank // 2
        assert dist.get_rank(mesh.groups[("data",)]) == rank % 2
        xs = np.load(os.path.join(workdir, "inputs.npz"))["xs"]
        d = xs.shape[-1]
        out = {}
        for name in COMPRESSORS:
            comp = get_compressor(name, block_size=block)
            for nb in (1, NB):
                errs = hier_errs(d, 2, 2, dev)
                for step in range(EXCHANGE_STEPS):
                    x = torch.from_numpy(xs[step, rank]).to(dev)
                    m, errs = compressed_exchange(x, errs, ("data",),
                                                  ("pod",), comp,
                                                  n_buckets=nb)
                    key = f"{name}_nb{nb}_s{step}"
                    out[key + "_out"] = m.cpu().numpy()
                    for slot, e in errs.items():
                        out[f"{key}_{slot}"] = e.cpu().numpy()
        try:
            compressed_exchange(
                torch.from_numpy(xs[0, rank]).to(dev),
                hier_errs(d, 2, 2, dev, outer=False), ("data",), ("pod",),
                get_compressor("topk", block_size=block))
            out["topk_no_outer_raised"] = False
        except ValueError:
            out["topk_no_outer_raised"] = True
        np.savez(os.path.join(workdir, f"{backend}{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _train_steps(spec: dict, rank: int, dev):
    """One entry of runs.json through ``train_step``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import build_mesh, pod_split
    from repro_torch.launch.train import lr_schedule
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import (init_train_state, seed_zero1,
                                        train_step)
    cfg = get_config(spec["arch"])
    block = spec["block"]
    mesh = build_mesh(spec["mesh"])
    n_dp = mesh.n_dp
    inner, outer, n_inner, n_outer = pod_split(mesh.axes, mesh.sizes)
    hier = spec["topology"] == "hier" and n_outer > 1
    opt = get_optimizer(spec.get("optimizer", "onebit_adam"),
                        compressor="onebit",
                        compressor_kwargs={"block_size": block},
                        **spec.get("opt_kwargs", {}))
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    ts = init_train_state(cfg, params, opt, block, n_dp, dev,
                          layout=spec.get("layout", "replicated"),
                          n_inner=n_inner if hier else None)
    stream = SyntheticStream(
        cfg, InputShape("t", spec["seq"], spec["batch"], "train"), seed=0,
        shard=rank, n_shards=n_dp, device=dev)
    losses, launches, ms, early, syncs = [], [], [], [], []
    for step in range(spec["steps"]):
        stage = "warmup" if step < spec["warmup"] else "compressed"
        sync = stage == "warmup" or ts.layout != "local" or \
            opt.sync_due(step - spec["warmup"])
        if spec.get("zero1") and step == spec["warmup"]:
            seed_zero1(ts, opt, inner, outer,
                       n_inner=n_inner if hier else None)
        batch = stream.batch_at(step)
        before = build.launch_counts()
        t0 = time.perf_counter()
        m = train_step(ts, opt, batch, lr_schedule(step, 2e-3, 2), stage,
                       inner, sync=sync, accum_steps=spec.get("accum", 1),
                       pod_axes=outer, topology=spec["topology"],
                       n_buckets=spec["n_buckets"],
                       overlap_bwd=spec["overlap"])
        losses.append(float(m["loss"]))         # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        early.append(ts.stage0_in_bwd)
        syncs.append(sync)
        after = build.launch_counts()
        launches.append([after[k] - before[k]
                         for k in ("adam_step", "ef_compress",
                                   "decompress")])
    keep = _digest if spec.get("digest") else (lambda t: t.cpu().numpy())
    out = {"loss": np.array(losses), "ms": np.array(ms),
           "launches": np.array(launches), "sync": np.array(syncs),
           "stage0_in_bwd": np.array(early), "x": keep(ts.x)}
    for k, v in ts.opt.items():
        out["opt_" + k] = keep(v)
    del ts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _digest(t: torch.Tensor) -> np.ndarray:
    return np.array(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest())


def steps_main(rank: int, world: int, workdir: str, backend: str) -> None:
    dev = _init(rank, world, workdir, backend, "steps")
    try:
        with open(os.path.join(workdir, "runs.json")) as f:
            specs = json.load(f)
        out = {}
        for name, spec in specs.items():
            for k, v in _train_steps(spec, rank, dev).items():
                out[f"{name}__{k}"] = v
        np.savez(os.path.join(workdir, f"steps{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_main(rank: int, world: int, workdir: str, backend: str) -> None:
    from repro_torch.launch.train import run
    dev = _init(rank, world, workdir, backend, "run")
    try:
        with open(os.path.join(workdir, "runs.json")) as f:
            specs = json.load(f)
        out = {}
        for name, kw in specs.items():
            keep = _digest if kw.pop("digest", False) else \
                (lambda t: t.cpu().numpy())
            res = run(device=dev.type, verbose=False, **kw)
            out[f"{name}__loss"] = np.array(
                [h["loss"] for h in res["history"]])
            out[f"{name}__overlap"] = np.array(
                [h["overlap"] for h in res["history"]])
            out[f"{name}__ms"] = np.array([h["ms"] for h in res["history"]])
            out[f"{name}__x"] = keep(res["state"].x)
            out[f"{name}__plan"] = np.array(res["plan"])
            out[f"{name}__stage0_in_bwd"] = np.array(
                [h["stage0_in_bwd"] for h in res["history"]])
            for k, v in res["state"].opt.items():
                out[f"{name}__opt_{k}"] = keep(v)
            for k, v in res["checkpoint_s"].items():
                out[f"{name}__{k}_s"] = np.array(v)
            del res
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        np.savez(os.path.join(workdir, f"run{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


LAYOUT_BLOCK = 4096
LAYOUT_D = 4 * 8 * LAYOUT_BLOCK


def _exact_grad(seed: int, step: int, rank: int, dev) -> torch.Tensor:
    """Multiples of 2^-14 below 1/16: four of them sum exactly in f32."""
    rng = np.random.default_rng([seed, step, rank])
    g = rng.integers(-2 ** 10, 2 ** 10, LAYOUT_D).astype(np.float32)
    return torch.from_numpy(g * np.float32(2.0 ** -14)).to(dev)


def layouts_main(rank: int, world: int, workdir: str, backend: str,
                 on_card: bool = False) -> None:
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.train import lr_schedule
    from repro_torch.optim import SegmentInfo, get_optimizer
    from repro_torch.train.step import TrainState, seed_zero1
    dev = _init(rank, world, workdir, backend, "layouts", on_card)
    try:
        with open(os.path.join(workdir, "runs.json")) as f:
            specs = json.load(f)
        mesh = build_mesh("2x2x1")
        axes = mesh.axes                    # the flat topology: both
        segs = SegmentInfo((LAYOUT_D,))
        out = {}
        for name, spec in specs.items():
            opt = get_optimizer(spec["optimizer"],
                                compressor=spec["compressor"],
                                compressor_kwargs={"block_size":
                                                   LAYOUT_BLOCK},
                                **spec.get("opt_kwargs", {}))
            layout = spec.get("layout", "replicated")
            ts = TrainState(model=None, x=torch.from_numpy(
                np.random.default_rng(7).standard_normal(LAYOUT_D)
                .astype(np.float32) * np.float32(0.05)).to(dev), g=None,
                opt=opt.init_state(LAYOUT_D, world, 1, layout=layout,
                                   device=dev), d=LAYOUT_D, segs=segs,
                layout=layout)
            w = spec["warmup"]
            for step in range(spec["steps"]):
                g = _exact_grad(spec["seed"], step, rank, dev)
                lr = lr_schedule(step, 2e-3, 2)
                before = build.launch_counts()
                if step < w:
                    sync = True
                    x, ts.opt, _ = opt.warmup_update(g, ts.opt, ts.x, lr,
                                                     dp_axes=axes,
                                                     segs=segs)
                else:
                    if spec.get("zero1") and step == w:
                        seed_zero1(ts, opt, axes)
                    sync = ts.layout != "local" or opt.sync_due(step - w)
                    x, ts.opt, _ = opt.update(g, ts.opt, lr, x=ts.x,
                                              dp_axes=axes, segs=segs,
                                              sync=sync)
                ts.x = x.to(torch.float32)
                after = build.launch_counts()
                key = f"{name}__s{step}"
                out[key + "_sync"] = np.array(sync)
                out[key + "_launches"] = np.array(
                    [after[k] - before[k] for k in ("adam_step",
                                                    "ef_compress",
                                                    "decompress")])
                out[key + "_x"] = ts.x.cpu().numpy()
                for k, v in ts.opt.items():
                    out[f"{key}_opt_{k}"] = v.cpu().numpy()
        np.savez(os.path.join(workdir, f"layouts_{backend}{rank}.npz"),
                 **out)
    finally:
        dist.destroy_process_group()
