"""The training step: forward/backward into a flat f32 gradient (summed over
the microbatches of gradient accumulation), then the optimizer's warmup
or compressed update, then the dp-mean metrics.

The reference runs this inside one ``shard_map``; here each process is
one dp rank and the only dp communication is the optimizer's own exchange
(``repro_torch.core.comm``): an uncompressed all-reduce mean in the
warmup stage, the error-compensated compressed all_to_all/all_gather
schedule in the compression stage.  Autograd averages nothing over dp.

State lives in a :class:`TrainState`: the flat parameter vector ``x``
(length ``d_pad``, the ravel order of the reference, zero tail), the flat
gradient ``g`` the model's parameters accumulate into, the model whose
parameters are views of ``x``, the optimizer's state tree, its
:class:`~repro_torch.optim.base.SegmentInfo` and its layout:

  ``replicated``  m/v the same on every dp rank (the paper's layout);
  ``local``       m/v/scale per dp rank: required when the optimizer may
                  skip syncs (0/1 Adam's 0-bit steps, ``sync=False``);
  ``zero1``       v and f32 master weights dp-sharded; the model's
                  weights take the bf16 replica the optimizer gathers.

The step writes the new parameters into ``x[:d]`` in place; as in the
reference, the padding tail of ``x`` stays zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import flat_from_params
from repro_torch.core import comm
from repro_torch.core.compression import padded_length
from repro_torch.models.transformer import (Transformer, flat_size,
                                            leaf_shapes, loss_fn)
from repro_torch.optim.base import (SegmentInfo, TwoStageOptimizer,
                                    segments_of)
from repro_torch.state.slots import StateTree

STAGES = ("warmup", "compressed")


def flat_dim(cfg: ArchConfig, n_dp: int, block: int) -> int:
    """Padded flat parameter length: a multiple of n_dp * block."""
    return padded_length(flat_size(cfg), max(n_dp, 1), block)


def segment_info(cfg: ArchConfig, d_pad: int) -> SegmentInfo:
    """ravel_pytree leaves, plus the padding tail as its own segment."""
    return segments_of([math.prod(s) for _, s in leaf_shapes(cfg)], d_pad)


@dataclasses.dataclass
class TrainState:
    model: Transformer
    x: torch.Tensor          # (d_pad,) flat params; model params are views
    g: torch.Tensor          # (d_pad,) flat grads; model grads are views
    opt: StateTree
    d: int                   # unpadded parameter count
    segs: SegmentInfo
    layout: str = "replicated"


def _dp_rank(dp_axes: Sequence[str]) -> int:
    return dist.get_rank() if dp_axes else 0


def init_train_state(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                     optimizer: TwoStageOptimizer, block: int,
                     n_dp: int = 1, device="cpu",
                     layout: str = "replicated") -> TrainState:
    """Flat buffers, the model over them, and zeros optimizer state in
    ``layout``; under zero1 this rank's f32 master chunk starts as its
    chunk of the parameters."""
    d = flat_size(cfg)
    d_pad = flat_dim(cfg, n_dp, block)
    x = flat_from_params(params, d_pad).to(device)
    g = torch.zeros_like(x)
    model = Transformer(cfg, x)
    model.bind_grads(g)
    segs = segment_info(cfg, d_pad)
    opt = optimizer.init_state(d_pad, n_dp, segs.n, layout=layout,
                               device=device)
    ts = TrainState(model=model, x=x, g=g, opt=opt, d=d, segs=segs,
                    layout=layout)
    if layout == "zero1":
        lo, hi = _chunk(ts, n_dp, dist.get_rank() if n_dp > 1 else 0)
        ts.opt = ts.opt._replace(master_shard=x[lo:hi].clone())
    return ts


def _chunk(ts: TrainState, n_dp: int, rank: int):
    chunk = ts.x.shape[0] // max(n_dp, 1)
    return rank * chunk, (rank + 1) * chunk


def seed_zero1(ts: TrainState, optimizer: TwoStageOptimizer,
               dp_axes: Sequence[str] = ()) -> None:
    """Move ``ts`` from the replicated layout (after the warmup) to zero1,
    as the reference's tests seed it: ``m``, the EF slots, ``scale`` and
    the counters carry over, this rank's chunk of ``v`` becomes
    ``v_shard`` and its chunk of the parameters ``master_shard``."""
    if ts.layout != "replicated":
        raise ValueError(f"seed_zero1 takes the replicated layout, not "
                         f"{ts.layout!r}")
    n = comm.axis_size(dp_axes)
    lo, hi = _chunk(ts, n, _dp_rank(dp_axes))
    z = optimizer.init_state(ts.x.shape[0], n, ts.segs.n, layout="zero1",
                             device=ts.x.device)
    carry = {k: ts.opt[k] for k in z if k in ts.opt}
    carry.update(v_shard=ts.opt.v[lo:hi].clone(),
                 master_shard=ts.x[lo:hi].clone())
    ts.opt, ts.layout = z._replace(**carry), "zero1"


def _dp_mean(vals: Dict[str, torch.Tensor], dp_axes: Sequence[str]
             ) -> Dict[str, torch.Tensor]:
    """Mean over dp of a dict of scalars, in one all-reduce."""
    if not dp_axes:
        return vals
    keys = list(vals)
    buf = torch.stack([vals[k].to(torch.float32) for k in keys])
    return dict(zip(keys, comm.allreduce_mean(buf, dp_axes).unbind()))


def _grads(ts: TrainState, batch: Dict[str, torch.Tensor],
           accum_steps: int):
    """Fill ``ts.g`` with this rank's gradient, accumulation averaged in
    as the reference's ``_grad_tree``: the microbatch gradients summed in
    order, then divided by ``accum_steps``.  Returns (total, metrics)."""
    ts.g.zero_()
    a = accum_steps
    if a <= 1:
        total, metrics = loss_fn(ts.model, batch)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}
    b = next(iter(batch.values())).shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    mb = b // a
    total, metrics = None, None
    for i in range(a):
        tot, met = loss_fn(ts.model,
                           {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()})
        tot.backward()          # accumulates into the views of ts.g
        tot, met = tot.detach(), {k: v.detach() for k, v in met.items()}
        total = tot if total is None else total + tot
        metrics = met if metrics is None else \
            {k: metrics[k] + met[k] for k in metrics}
    with torch.no_grad():
        ts.g.div_(a)
    return total / a, {k: v / a for k, v in metrics.items()}


def train_step(ts: TrainState, optimizer: TwoStageOptimizer,
               batch: Dict[str, torch.Tensor], lr: float, stage: str,
               dp_axes: Sequence[str] = (), sync: bool = True,
               accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """One step of ``stage`` ("warmup" | "compressed"); updates ``ts`` and
    returns the metrics (0-dim tensors): loss/aux/acc/total dp-meaned,
    ``v_l1`` (the global one: summed over the shards under zero1,
    dp-meaned under local), the other :data:`STAT_KEYS` dp-meaned.

    ``sync=False`` is a 0-bit compression-stage step (no exchange, no
    model update) and needs the ``local`` layout.  Under zero1 every step
    is a compressed update, as in the reference."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if not sync and ts.layout != "local":
        raise ValueError("sync=False (0-bit local steps) requires "
                         "layout='local'")
    total, metrics = _grads(ts, batch, accum_steps)
    sharded = "master_shard" in ts.opt
    if sharded:
        new_x, ts.opt, stats = optimizer.update(
            ts.g, ts.opt, lr, dp_axes=dp_axes, segs=ts.segs, sync=sync)
    elif stage == "warmup":
        new_x, ts.opt, stats = optimizer.warmup_update(
            ts.g, ts.opt, ts.x, lr, dp_axes=dp_axes, segs=ts.segs)
    else:
        new_x, ts.opt, stats = optimizer.update(
            ts.g, ts.opt, lr, x=ts.x, dp_axes=dp_axes, segs=ts.segs,
            sync=sync)
    with torch.no_grad():
        ts.x[:ts.d].copy_(new_x[:ts.d])
    out = dict(metrics)
    out["total"] = total
    out.update({k: v for k, v in stats.items() if k != "v_l1"})
    out = _dp_mean(out, dp_axes)
    v_l1 = stats["v_l1"]
    if dp_axes and (sharded or ts.layout == "local"):
        v_l1 = v_l1.clone()
        dist.all_reduce(v_l1)           # zero1: the shards' sum
        if not sharded:
            v_l1 = v_l1 / comm.axis_size(dp_axes)
    out["v_l1"] = v_l1
    return out
