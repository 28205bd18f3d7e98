"""The functional oracles of the port (``repro_torch.core.{momentum,
onebit_adam}``) on one dp rank, for tests/test_torch_core_oracles.py.  It
imports torch and the port only.

``run_cases(data, rank, n, axes, device)`` runs every case on this rank's
gradients from ``data`` (``grads`` (steps, n, d), ``x0`` (d,)) and returns
numpy arrays keyed ``<case>_s<step>_<name>``: the state after each step,
its stats, and for every EF-compress of the exchange its inputs and the
payload it put on the wire (``w*`` the worker's, ``s*`` the server's).
``oracle_main``: ``run_cases`` as one of ``world`` gloo ranks (``file://``
rendezvous in ``workdir``), saved to ``rank<r>.npz``.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import momentum as M
from repro_torch.core import onebit_adam as OB
from repro_torch.optim.compressors import (Compressor, IdentityCompressor,
                                           OneBitCompressor)

BLOCK = 4096
D = 4 * BLOCK * 2
MSGD_STEPS = 4
WARMUP, COMPRESSED, ZERO1 = 5, 5, 3
STEPS = WARMUP + COMPRESSED
LR = 1e-3
MSGD_LR = 1e-2


class Recording(Compressor):
    """Wraps a compressor: keeps the inputs and payload of every
    ``ef_compress`` (two per exchange: worker, then server)."""

    def __init__(self, comp):
        self.comp, self.calls = comp, []
        self.name, self.lossless, self.dense = (comp.name, comp.lossless,
                                                comp.dense)
        self.block_size = comp.block_size

    def ef_compress(self, x, err, out=None):
        payload, new_err = self.comp.ef_compress(x, err, out=out)
        self.calls.append((x.clone(), err.clone(),
                           tuple(p.clone() for p in payload)))
        return payload, new_err

    def compress(self, x):
        return self.comp.compress(x)

    def decompress(self, payload, out=None):
        return self.comp.decompress(payload, out=out)

    def wire_specs(self, d):
        return self.comp.wire_specs(d)

    def take(self, out: dict, key: str) -> None:
        for who, (x, err, payload) in zip("ws", self.calls):
            out[f"{key}_{who}in"] = x
            out[f"{key}_{who}err_in"] = err
            for i, p in enumerate(payload):
                out[f"{key}_{who}p{i}"] = p
        self.calls = []


def _compressor(kind):
    return Recording(IdentityCompressor() if kind == "identity"
                     else OneBitCompressor(block_size=BLOCK))


def _save_state(out: dict, key: str, x, state, stats=None) -> None:
    out[f"{key}_x"] = x
    for f, v in state._asdict().items():
        out[f"{key}_{f}"] = v
    for k, v in (stats or {}).items():
        out[f"{key}_stat_{k}"] = v


def run_cases(data, rank: int, n: int, axes, device) -> dict:
    grads = torch.from_numpy(data["grads"][:, rank].copy()).to(device)
    x0 = torch.from_numpy(data["x0"].copy()).to(device)
    out = {}
    for kind in ("identity", "onebit"):
        comp = _compressor(kind)
        cfg = M.MomentumConfig(compression=comp)
        x, st = x0, M.init(D, n, device)
        for t in range(MSGD_STEPS):
            x, st = M.update(grads[t], st, x, cfg, MSGD_LR, axes)
            key = f"msgd_{kind}_s{t}"
            _save_state(out, key, x, st)
            comp.take(out, key)
    comp = _compressor("onebit")
    x, st = x0, M.naive_init(D, n, device)
    for t in range(MSGD_STEPS):
        x, st = M.naive_compressed_adam_update(grads[t], st, x, 0.9, 0.999,
                                               1e-8, LR, comp, axes)
        _save_state(out, f"naive_s{t}", x, st)
        comp.take(out, f"naive_s{t}")
    comp = _compressor("onebit")
    cfg = OB.OneBitAdamConfig(compression=comp)
    x, st = x0, OB.init(D, n, device)
    for t in range(STEPS):
        step = OB.warmup_update if t < WARMUP else OB.compressed_update
        x, st, stats = step(grads[t], st, x, cfg, LR, axes)
        _save_state(out, f"ob_s{t}", x, st, stats)
        if t == WARMUP - 1:
            warm = (x, st)
        comp.take(out, f"ob_s{t}")
    # zero1 from the warmup's state: this rank's chunk of v and x
    x, st = warm
    chunk = D // n
    lo = rank * chunk
    z = OB.ZeroOneBitAdamState(
        m=st.m, v_shard=st.v[lo:lo + chunk].clone(),
        master_shard=x[lo:lo + chunk].clone(), worker_err=st.worker_err,
        server_err=st.server_err, count=st.count)
    for t in range(ZERO1):
        x_full, z, stats = OB.zero1_compressed_update(
            grads[WARMUP + t], z, cfg, LR, axes)
        # the bf16 replica as its bits
        _save_state(out, f"zero1_s{t}", x_full.view(torch.int16), z, stats)
        comp.take(out, f"zero1_s{t}")
    return {k: v.cpu().numpy() for k, v in out.items()}


def oracle_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)        # the ranks share the host's cores
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"),
                 **run_cases(data, rank, world, ("dp",),
                             torch.device("cpu")))
    finally:
        dist.destroy_process_group()
