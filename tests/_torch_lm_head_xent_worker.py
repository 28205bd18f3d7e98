"""The LM-head cross-entropy on gloo ranks, and the plain formula it
replaced.

``plain_xent`` is ``models.transformer.vocab_parallel_xent`` as it was
before the head went through ``kernels.lm_head_xent``: the f32 logits
materialised, masked, and reduced by autograd (``ref.plain_nll``, over
the same collectives).  ``tp_main`` runs one rank of a model axis of
``world`` ranks (file:// rendezvous under the test's directory) and
saves, for the TP case and SP's ``skip_gcopy``, the loss, the accuracy
and the gradients of both versions.  It imports torch and
the port only.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels.lm_head_xent import ref
from repro_torch.models.common import (MODEL_AXIS, NO_TP, ParallelCtx,
                                       f_reduce, g_copy, tp_rank)
from repro_torch.models.transformer import vocab_parallel_xent
from repro_torch.obs.trace import count_collective

VOCAB, V_PAD, D, B, S = 250, 256, 48, 3, 10


def plain_xent(x, w_out, labels, mask, cfg, ctx=NO_TP, skip_gcopy=False):
    """The head's loss and accuracy through materialised f32 logits."""
    xin = x if skip_gcopy else g_copy(x, ctx)
    v_l = w_out.shape[-1]
    off = tp_rank(ctx) * v_l
    local = labels.long() - off
    lab = torch.where((local >= 0) & (local < v_l), local, -1)

    def row_max(m):
        if ctx.tp > 1:
            count_collective("all_reduce", m, (MODEL_AXIS,), ctx.tp)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ctx.group)
        return m

    nll, ll, m = ref.plain_nll(xin, w_out, lab,
                               min(max(cfg.vocab - off, 0), v_l), row_max,
                               lambda v: f_reduce(v, ctx))
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    correct = ((ll.detach() - m).abs() < 1e-6) & (mask > 0)
    return loss, correct.sum() / denom


def config(vocab: int = VOCAB):
    return dataclasses.replace(get_config("bert-large-smoke"), vocab=vocab)


def inputs(seed: int, dtype=torch.float32, b=B, s=S, d=D, v_pad=V_PAD,
           vocab=VOCAB, mask_zeros=True):
    """x (b, s, d) in ``dtype``, w (d, v_pad) f32, labels below ``vocab``
    and a 0/1 mask (some rows 0), from numpy."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, v_pad), np.float32) * 0.3)
    labels = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    mask = (rng.random((b, s)) > (0.3 if mask_zeros else -1.0))
    return x.to(dtype), w, labels, torch.from_numpy(mask.astype(np.float32))


def loss_and_grads(fn, x, w, labels, mask, cfg, ctx=NO_TP,
                   skip_gcopy=False):
    """(loss, acc, dx, dw) of ``fn`` with x and w as leaves."""
    x = x.detach().clone().requires_grad_()
    w = w.detach().clone().requires_grad_()
    loss, acc = fn(x, w, labels, mask, cfg, ctx, skip_gcopy)
    loss.backward()
    return [t.detach().float().numpy() for t in (loss, acc, x.grad, w.grad)]


def tp_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world)
    cfg = config()
    out = {}
    v_l = V_PAD // world
    for sp in (False, True):
        ctx = ParallelCtx(group=None, tp=world, sp=sp)
        x, w, labels, mask = inputs(7, torch.bfloat16)
        shard = w[:, rank * v_l:(rank + 1) * v_l]
        for name, fn in (("new", vocab_parallel_xent), ("plain", plain_xent)):
            got = loss_and_grads(fn, x, shard, labels, mask, cfg, ctx,
                                 skip_gcopy=sp)
            for key, val in zip(("loss", "acc", "dx", "dw"), got):
                out[f"{name}_{'sp' if sp else 'tp'}_{key}"] = val
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
