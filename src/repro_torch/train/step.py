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

Axes: ``dp_axes`` are the intra-pod dp axes of the mesh and ``pod_axes``
the cross-pod ones (empty on one pod); the warmup mean, the metrics and
the zero1 shards span both.  ``topology="hier"`` runs the compressed
exchange as the two-level schedule; on one pod it is the flat one, as in
the reference.  ``n_buckets > 1`` pipelines the exchange.

Backward overlap (``overlap_bwd``, the counterpart of the reference's
``flat_grad_parts``): the gradient parts are the bucket slices of ``g``,
of which the parameters' gradients are views.  A hook after the
accumulation of each parameter's gradient counts down the buckets it
overlaps; on the last microbatch a bucket whose parameters have all
fired is divided by ``accum_steps`` (as ``_grads`` divides the whole
``g``), its momentum folded and its exchange's first stage issued from
inside backward.  The buckets issue in a fixed order derived from the
model, not from when each rank's hooks happen to fire: by the position,
in :meth:`Transformer.grad_order`, of each bucket's last gradient to land
(:func:`backward_ready_order`).  A bucket ready early waits for its
predecessors in that order, so every rank issues the same collectives in
the same order.  The rest of the wavefront runs after backward.  It
applies to a compressed-stage step with ``sync=True`` and more than one
bucket (:func:`overlap_applies`); every other step takes the serial
path, with the same numerics.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import flat_from_params
from repro_torch.core import comm
from repro_torch.core.compression import padded_length
from repro_torch.models.transformer import (Transformer, flat_size,
                                            leaf_shapes, loss_fn)
from repro_torch.optim.base import (SegmentInfo, TwoStageOptimizer,
                                    get_optimizer, segments_of)
from repro_torch.optim.compressors import from_config
from repro_torch.plan.executor import group_of
from repro_torch.state.slots import StateTree

STAGES = ("warmup", "compressed")
TOPOLOGIES = ("flat", "hier")


def optimizer_from_config(ocfg) -> TwoStageOptimizer:
    """The registry ``onebit_adam`` a functional ``OneBitAdamConfig``
    (``repro_torch.core.onebit_adam``) describes: its compressor, ``b1``,
    ``b2``, ``eps``, ``weight_decay`` and ``bias_correction`` (the
    reference's ``TrainStepConfig(opt=...).build_optimizer``)."""
    return get_optimizer(
        "onebit_adam", compressor=from_config(ocfg.compression), b1=ocfg.b1,
        b2=ocfg.b2, eps=ocfg.eps, weight_decay=ocfg.weight_decay,
        bias_correction=ocfg.bias_correction)


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
    # backward overlap on the last step: stage 0s issued before the last
    # gradient landed (0 on a step without overlap)
    stage0_in_bwd: int = 0


def init_train_state(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                     optimizer: TwoStageOptimizer, block: int,
                     n_dp: int = 1, device="cpu",
                     layout: str = "replicated",
                     n_inner: Optional[int] = None) -> TrainState:
    """Flat buffers, the model over them, and zeros optimizer state in
    ``layout``; under zero1 this rank's f32 master chunk starts as its
    chunk of the parameters.  ``n_dp`` counts every dp rank (the padding
    basis); ``n_inner`` is the pod size of the hierarchical topology,
    which sizes the server and cross-pod EF chunks (None = flat)."""
    d = flat_size(cfg)
    d_pad = flat_dim(cfg, n_dp, block)
    x = flat_from_params(params, d_pad).to(device)
    g = torch.zeros_like(x)
    model = Transformer(cfg, x)
    model.bind_grads(g)
    segs = segment_info(cfg, d_pad)
    opt = optimizer.init_state(d_pad, n_dp, segs.n, n_inner=n_inner,
                               layout=layout, device=device)
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
               dp_axes: Sequence[str] = (), pod_axes: Sequence[str] = (),
               n_inner: Optional[int] = None) -> None:
    """Move ``ts`` from the replicated layout (after the warmup) to zero1,
    as the reference's tests seed it: ``m``, the EF slots, ``scale`` and
    the counters carry over, this rank's chunk of ``v`` becomes
    ``v_shard`` and its chunk of the parameters ``master_shard`` (chunks
    over every dp rank, pods leading)."""
    if ts.layout != "replicated":
        raise ValueError(f"seed_zero1 takes the replicated layout, not "
                         f"{ts.layout!r}")
    axes = tuple(pod_axes) + tuple(dp_axes)
    n = comm.axis_size(axes)
    lo, hi = _chunk(ts, n, comm.axis_index(axes))
    z = optimizer.init_state(ts.x.shape[0], n, ts.segs.n, n_inner=n_inner,
                             layout="zero1", device=ts.x.device)
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


def _buckets_of(ts: TrainState, buckets):
    """(parameter, indices of the buckets it overlaps) in the model's
    :meth:`~repro_torch.models.transformer.Transformer.grad_order`."""
    base = ts.x.data_ptr()
    out = []
    for p in ts.model.grad_order():
        lo = (p.data_ptr() - base) // p.element_size()
        hi = lo + p.numel()
        out.append((p, tuple(b for b, bp in enumerate(buckets)
                             if bp.offset < hi and lo < bp.offset + bp.size)))
    return out


def backward_ready_order(ts: TrainState, buckets) -> tuple:
    """Bucket indices in the order backward completes them: by the
    position in the model's ``grad_order`` of each bucket's last
    gradient to land (a bucket of padding alone first), ties by index.
    Static, so the same on every rank."""
    last = [-1] * len(buckets)
    for pos, (_, bs) in enumerate(_buckets_of(ts, buckets)):
        for b in bs:
            last[b] = pos
    return tuple(sorted(range(len(buckets)), key=lambda b: (last[b], b)))


class _Overlap:
    """The backward-overlap front end of one step (see module doc).
    ``early`` counts the stage 0s issued while gradients were still to
    land, i.e. before the last parameter's hook."""

    def __init__(self, ts: TrainState, optimizer: TwoStageOptimizer,
                 exchange, accum_steps: int):
        self.ts, self.optimizer, self.ex = ts, optimizer, exchange
        self.accum = accum_steps
        self.armed = False
        self.waiting = [0] * exchange.pplan.n_buckets
        self.handles = []
        for p, bs in _buckets_of(ts, exchange.pplan.buckets):
            for b in bs:
                self.waiting[b] += 1
            self.handles.append(p.register_post_accumulate_grad_hook(
                functools.partial(self._fired, bs)))
        self.left = len(self.handles)
        self.early = 0

    def arm(self) -> None:
        """Before the last microbatch's backward: from now on a bucket
        whose parameters have all fired is fed and issued (a bucket of
        padding alone at once)."""
        self.armed = True
        self._feed_ready()

    def _fired(self, buckets, _param) -> None:
        if not self.armed:
            return
        for b in buckets:
            self.waiting[b] -= 1
        self.left -= 1
        self._feed_ready()
        if self.left:
            self.early = self.ex.stage0_issued

    def _feed_ready(self, every: bool = False) -> None:
        ts = self.ts
        with torch.no_grad():
            for b, bp in enumerate(self.ex.pplan.buckets):
                if self.ex.fed(b) or (self.waiting[b] and not every):
                    continue
                g = ts.g[bp.offset:bp.offset + bp.size]
                if self.accum > 1:
                    g.div_(self.accum)
                self.ex.feed(b, self.optimizer.fold_momentum(
                    ts.opt, bp.offset, g))
                self.ex.issue_ready()       # frees the folded part early

    def remove_hooks(self) -> None:
        for h in self.handles:
            h.remove()

    def feed_rest(self) -> None:
        """After backward: feed the buckets still waiting (a parameter
        without a gradient)."""
        self._feed_ready(every=True)


def _grads(ts: TrainState, batch: Dict[str, torch.Tensor],
           accum_steps: int, overlap: Optional[_Overlap] = None):
    """Fill ``ts.g`` with this rank's gradient, accumulation averaged in
    as the reference's ``_grad_tree``: the microbatch gradients summed in
    order, then divided by ``accum_steps`` (under backward overlap each
    bucket's slice divides as it is fed).  Returns (total, metrics)."""
    ts.g.zero_()
    a = max(accum_steps, 1)
    b = next(iter(batch.values())).shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    mb = b // a
    total, metrics = None, None
    for i in range(a):
        tot, met = loss_fn(ts.model, batch if a == 1 else
                           {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()})
        last = overlap is not None and i == a - 1
        if last:
            overlap.arm()
        try:
            tot.backward()      # accumulates into the views of ts.g
        finally:
            if last:
                overlap.remove_hooks()
        if last:
            overlap.feed_rest()
        tot, met = tot.detach(), {k: v.detach() for k, v in met.items()}
        total = tot if total is None else total + tot
        metrics = met if metrics is None else \
            {k: metrics[k] + met[k] for k in metrics}
    if a == 1:
        return total, metrics
    if overlap is None:
        with torch.no_grad():
            ts.g.div_(a)
    return total / a, {k: v / a for k, v in metrics.items()}


def overlap_applies(stage: str, sync: bool, n_buckets: int,
                    overlap_bwd: bool) -> bool:
    """Whether backward overlap runs on such a step: a compressed-stage
    step that synchronises, over more than one bucket (the reference's
    condition)."""
    return bool(overlap_bwd) and stage == "compressed" and sync \
        and n_buckets > 1


def exchange_axes(topology: str, dp_axes: Sequence[str] = (),
                  pod_axes: Sequence[str] = ()):
    """(within-pod, cross-pod) axes of the compressed exchange: the
    two-level split under ``hier`` with pod axes, else every dp axis
    within one "pod" (the flat schedule)."""
    if topology == "hier" and pod_axes:
        return tuple(dp_axes), tuple(pod_axes)
    return tuple(pod_axes) + tuple(dp_axes), ()


def train_step(ts: TrainState, optimizer: TwoStageOptimizer,
               batch: Dict[str, torch.Tensor], lr: float, stage: str,
               dp_axes: Sequence[str] = (), sync: bool = True,
               accum_steps: int = 1, pod_axes: Sequence[str] = (),
               topology: str = "flat", n_buckets: int = 1,
               overlap_bwd: bool = False) -> Dict[str, torch.Tensor]:
    """One step of ``stage`` ("warmup" | "compressed"); updates ``ts`` and
    returns the metrics (0-dim tensors): loss/aux/acc/total dp-meaned,
    ``v_l1`` (the global one: summed over the shards under zero1,
    dp-meaned under local), the other :data:`STAT_KEYS` dp-meaned.

    ``sync=False`` is a 0-bit compression-stage step (no exchange, no
    model update) and needs the ``local`` layout.  Under zero1 every step
    is a compressed update, as in the reference.  See the module doc for
    the axes, ``topology``, ``n_buckets`` and ``overlap_bwd``."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; one of "
                         f"{TOPOLOGIES}")
    if not sync and ts.layout != "local":
        raise ValueError("sync=False (0-bit local steps) requires "
                         "layout='local'")
    all_axes = tuple(pod_axes) + tuple(dp_axes)
    inner, outer = exchange_axes(topology, dp_axes, pod_axes)
    sharded = "master_shard" in ts.opt
    overlap = None
    if overlap_applies(stage, sync, n_buckets, overlap_bwd):
        ex = optimizer.start_exchange(
            ts.opt, dp_axes=inner, pod_axes=outer, n_buckets=n_buckets,
            order_of=functools.partial(backward_ready_order, ts))
        if ex is not None:
            overlap = _Overlap(ts, optimizer, ex, accum_steps)
    total, metrics = _grads(ts, batch, accum_steps, overlap)
    ts.stage0_in_bwd = overlap.early if overlap is not None else 0
    kw = dict(dp_axes=inner, pod_axes=outer, segs=ts.segs, sync=sync,
              n_buckets=n_buckets,
              exchange=overlap.ex if overlap is not None else None)
    if sharded:
        new_x, ts.opt, stats = optimizer.update(ts.g, ts.opt, lr, **kw)
    elif stage == "warmup":
        new_x, ts.opt, stats = optimizer.warmup_update(
            ts.g, ts.opt, ts.x, lr, dp_axes=all_axes, segs=ts.segs)
    else:
        new_x, ts.opt, stats = optimizer.update(ts.g, ts.opt, lr, x=ts.x,
                                                **kw)
    with torch.no_grad():
        ts.x[:ts.d].copy_(new_x[:ts.d])
    out = dict(metrics)
    out["total"] = total
    out.update({k: v for k, v in stats.items() if k != "v_l1"})
    out = _dp_mean(out, all_axes)
    v_l1 = stats["v_l1"]
    if all_axes and (sharded or ts.layout == "local"):
        v_l1 = v_l1.clone()
        dist.all_reduce(v_l1, group=group_of(all_axes))  # zero1: the sum
        if not sharded:
            v_l1 = v_l1 / comm.axis_size(all_axes)
    out["v_l1"] = v_l1
    return out
