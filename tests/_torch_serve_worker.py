"""Spawned ranks of the serving tests (tests/test_torch_serve_families.py
over gloo, the four-card test of tests/test_torch_cuda.py over NCCL).
They import torch and the port only.

``decode_main``: ``train.step.make_serve_step`` over a dp mesh of every
rank for the decode shape of ``case.json`` (arch, compute dtype, batch,
cache length, the positions of the steps), the params of ``params.npz``
(dotted paths) and the tokens of ``tokens.npz`` (B, steps): zero caches
from the step's ``init_caches``, then one decode step a position; saves
each step's logits (this rank's rows) and ``seq_sharded`` to
``decode_<backend><rank>.npz``; ``write_case`` writes those three
inputs.
"""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_hier_worker import _init


def write_case(workdir, case: dict, params, tokens: np.ndarray) -> None:
    """``case.json``, ``params.npz`` (the port's params, any device) and
    ``tokens.npz`` for :func:`decode_main` in ``workdir``."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "case.json"), "w") as f:
        json.dump(case, f)
    np.savez(os.path.join(workdir, "params.npz"),
             **{k: v.cpu().numpy() for k, v in params.items()})
    np.savez(os.path.join(workdir, "tokens.npz"), tokens=tokens)


def decode_main(rank: int, world: int, workdir: str, backend: str) -> None:
    dev = _init(rank, world, workdir, backend, "serve")
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.train.step import make_serve_step
    with open(os.path.join(workdir, "case.json")) as f:
        case = json.load(f)
    cfg = dataclasses.replace(get_config(case["arch"]),
                              compute_dtype=case["dtype"])
    params = {k: torch.from_numpy(v).to(dev) for k, v in
              np.load(os.path.join(workdir, "params.npz")).items()}
    toks = np.load(os.path.join(workdir, "tokens.npz"))["tokens"]
    step = make_serve_step(cfg, build_mesh(str(world)), InputShape(
        "d", case["seq"], case["batch"], "decode"), device=dev.type)
    caches = step.init_caches(dtype=getattr(torch, case["dtype"]))
    out = {"seq_sharded": np.array(step.seq_sharded)}
    for i, pos in enumerate(case["positions"]):
        logits, caches = step(params, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])}, caches, pos)
        out[f"s{i}"] = logits.float().cpu().numpy()
    np.savez(os.path.join(workdir, f"decode_{backend}{rank}.npz"), **out)
    dist.destroy_process_group()
