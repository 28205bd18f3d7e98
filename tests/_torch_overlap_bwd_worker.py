"""Spawned gloo ranks for tests/test_torch_overlap_bwd.py and
tests/test_torch_api_parity.py (they import torch and the port only).

``micro_main``: rank ``r`` runs ``overlap_check.build_bwd_exchange`` on
the weights and inputs of ``inputs.npz`` in ``workdir``, landing the
gradients ``grads<r>`` through its hooks instead of a backward pass, with
a compressor that records its payloads; saves the outputs and the
payloads to ``micro<r>.npz``.  ``hier_main``: the hierarchical exchange of
``inputs.npz``'s ``xs[r]`` on a 2 x 2 (pod x data) mesh, once through
``compressed_allreduce_hierarchical`` and once through
``compressed_exchange``, serial and over 2 buckets; saves both to
``hier<r>.npz``.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.compressors import OneBitCompressor


class RecordingCompressor(OneBitCompressor):
    """OneBitCompressor that keeps every payload its ef_compress emits
    (the pipelined executor passes ``out=`` for the new residual)."""

    def __init__(self, block_size):
        super().__init__(block_size=block_size)
        object.__setattr__(self, "payloads", [])

    def ef_compress(self, x, err, **kw):
        payload, new_err = super().ef_compress(x, err, **kw)
        self.payloads.append(tuple(p.clone() for p in payload))
        return payload, new_err


def _init(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)


def micro_main(rank: int, world: int, workdir: str, block: int,
               n_buckets: int) -> None:
    from repro_torch.benchmarks.overlap_check import build_bwd_exchange
    _init(rank, world, workdir)
    try:
        data = np.load(os.path.join(workdir, "inputs.npz"))
        ws = [data[f"w{i}"] for i in range(int(data["n_layers"]))]
        grads = [data[f"g{rank}_{i}"] for i in range(len(ws))]
        comp = RecordingCompressor(block)
        out, werr, serr = build_bwd_exchange(
            (world,), block, n_buckets, len(ws), ws[0].shape[0], ws=ws,
            x=data["x"], grads=grads, comp=comp, device="cpu")
        pay = {f"p{i}_{j}": p.numpy() for i, pl in enumerate(comp.payloads)
               for j, p in enumerate(pl)}
        np.savez(os.path.join(workdir, f"micro{rank}.npz"), out=out.numpy(),
                 werr=werr.numpy(), serr=serr.numpy(),
                 n_payloads=len(comp.payloads), **pay)
    finally:
        dist.destroy_process_group()


def hier_main(rank: int, world: int, workdir: str, block: int) -> None:
    from repro_torch.core import comm
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim import get_compressor
    _init(rank, world, workdir)
    try:
        build_mesh("2x2x1")
        x = torch.from_numpy(np.load(os.path.join(workdir,
                                                  "inputs.npz"))["xs"][rank])
        d = x.shape[0]
        comp = get_compressor("onebit", block_size=block)
        out = {}
        for nb in (1, 2):
            for name, fn in (("wrap", comm.compressed_allreduce_hierarchical),
                             ("exch", comm.compressed_exchange)):
                errs = {"worker": torch.zeros(d),
                        "server": torch.zeros(d // 2)}
                o, e = fn(x, errs, ("data",), ("pod",), comp, n_buckets=nb)
                out[f"{name}{nb}_out"] = o.numpy()
                out.update({f"{name}{nb}_{k}": v.numpy()
                            for k, v in e.items()})
        np.savez(os.path.join(workdir, f"hier{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def train_main(rank: int, world: int, workdir: str, kw: dict) -> None:
    """``launch.train.run(**kw)`` as rank ``rank`` of ``world`` NCCL ranks,
    one card each, with ``--profile workdir/prof``; saves the history's
    per-step stage, ``stage0_in_bwd`` and wall, and the launch counts, to
    ``train<rank>.json``."""
    import json
    from repro_torch.launch.train import run
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        res = run(device="cuda", profile=os.path.join(workdir, "prof"),
                  verbose=rank == 0, **kw)
        hist = [{k: h.get(k) for k in ("step", "stage", "stage0_in_bwd",
                                       "ms", "loss")}
                for h in res["history"]]
        with open(os.path.join(workdir, f"train{rank}.json"), "w") as f:
            json.dump({"history": hist, "launches": res["launches"],
                       "d_pad": res["d_pad"],
                       "n_buckets": res["n_buckets"]}, f)
    finally:
        dist.destroy_process_group()
