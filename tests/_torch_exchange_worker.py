"""Spawned gloo ranks for tests/test_torch_exchange.py (they import torch
and the port only).

``rank_main``: rank ``r`` loads its inputs from ``inputs.npz`` in
``workdir``, runs ``repro_torch.core.comm.compressed_allreduce`` over the
default process group, and saves its outputs and the payloads it put on
the wire to ``rank<r>.npz``.  ``train_main``: a few steps of the port's
``run`` on this rank, saved to ``train<r>.npz``.  ``payloads_main``: the
compressed exchange (``repro_torch.core.comm.compressed_exchange``) of
``inputs.npz`` under the top-k compressor (two payload leaves: f32 values
and uint16 indices) and the 1-bit one, over gloo on CPU tensors or NCCL on
this rank's card, saved to ``<backend><r>.npz``.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.comm import compressed_allreduce, compressed_exchange
from repro_torch.optim.compressors import OneBitCompressor, TopKCompressor


class RecordingCompressor(OneBitCompressor):
    """OneBitCompressor that keeps every payload its ef_compress emits."""

    def __init__(self, block_size):
        super().__init__(block_size=block_size)
        object.__setattr__(self, "payloads", [])

    def ef_compress(self, x, err):
        payload, new_err = super().ef_compress(x, err)
        self.payloads.append(tuple(p.clone() for p in payload))
        return payload, new_err


def rank_main(rank: int, world: int, workdir: str, block: int) -> None:
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        comp = RecordingCompressor(block)
        out, werr, serr = compressed_allreduce(
            torch.from_numpy(data["xs"][rank]),
            torch.from_numpy(data["werrs"][rank]),
            torch.from_numpy(data["serrs"][rank]), ("dp",), comp)
        (wpk, wsc), (spk, ssc) = comp.payloads
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), out=out.numpy(),
                 werr=werr.numpy(), serr=serr.numpy(), wpk=wpk.numpy(),
                 wsc=wsc.numpy(), spk=spk.numpy(), ssc=ssc.numpy())
    finally:
        dist.destroy_process_group()


def train_main(rank: int, world: int, workdir: str) -> None:
    """A few steps of the port's ``run`` as one of ``world`` gloo ranks;
    saves the loss history and this rank's flat parameters."""
    from repro_torch.launch.train import run
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        res = run(arch="bert-large-smoke", steps=4, warmup_steps=2,
                  batch=4, seq=32, block_size=512, lr=2e-3, lr_warmup=2,
                  device="cpu", verbose=False)
        hist = res["history"]
        np.savez(os.path.join(workdir, f"train{rank}.npz"),
                 loss=np.array([h["loss"] for h in hist]),
                 v_l1=np.array([h["v_l1"] for h in hist]),
                 stage=np.array([h["stage"] for h in hist]),
                 x=res["state"].x.numpy(), d_pad=res["d_pad"])
    finally:
        dist.destroy_process_group()


def payloads_main(rank: int, world: int, workdir: str, block: int,
                  backend: str) -> None:
    dev = torch.device("cuda", rank) if backend == "nccl" else \
        torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(
            workdir, f"rendezvous_{backend}"), rank=rank, world_size=world)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        out = {}
        for name, comp in (("topk", TopKCompressor(block_size=block)),
                           ("onebit", OneBitCompressor(block_size=block))):
            m, errs = compressed_exchange(
                torch.from_numpy(data["xs"][rank]).to(dev),
                {"worker": torch.from_numpy(data["werrs"][rank]).to(dev),
                 "server": torch.from_numpy(data["serrs"][rank]).to(dev)},
                ("dp",), comp)
            out[f"{name}_out"] = m.cpu().numpy()
            out[f"{name}_werr"] = errs["worker"].cpu().numpy()
            out[f"{name}_serr"] = errs["server"].cpu().numpy()
        np.savez(os.path.join(workdir, f"{backend}{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
