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

``flat_grads`` is the front half of the step on its own (the gradient
the step would exchange, as the reference's), and ``flat_grad_parts`` cuts
a gradient tree into the per-bucket parts of backward overlap.  With
tracing on, each phase of a step runs inside a range of ``obs.trace``:
each microbatch's forward in ``train.forward``, its backward pass in
``train.backward`` (the window ``overlap_check --bwd`` reads), the update
in ``optim.update`` and the metrics' reductions in ``train.metrics``.

``make_serve_step`` is the serving side: a prefill or decode step over
the dp x tp mesh (batch-sharded, or seq-sharded flash-decoding for a batch
smaller than the mesh), as the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.convert import flat_from_params, ravel_shapes
from repro_torch.core import comm
from repro_torch.core.compression import padded_length
from repro_torch.launch.mesh import pod_split
from repro_torch.models.common import NO_TP, ParallelCtx
from repro_torch.models.transformer import (Transformer, flat_size,
                                            leaf_shapes, loss_fn)
from repro_torch.obs.trace import (BACKWARD_SPAN, FORWARD_SPAN,
                                   METRICS_SPAN, UPDATE_SPAN,
                                   count_collective, scope)
from repro_torch.optim.base import LAYOUTS  # noqa: F401  (the reference's)
from repro_torch.optim.base import (SegmentInfo, TwoStageOptimizer,
                                    get_optimizer, segments_of)
from repro_torch.optim.compressors import from_config
from repro_torch.plan.executor import group_of
from repro_torch.state.slots import StateLayout, StateTree

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


def flat_dim(cfg: ArchConfig, n_dp: int, block: int, tp: int = 1) -> int:
    """Padded flat parameter length of one model rank at ``tp``: a
    multiple of n_dp * block (the reference's ``_flat_dim``)."""
    return padded_length(flat_size(cfg, tp), max(n_dp, 1), block)


def segment_info(cfg: ArchConfig, d_pad: int, tp: int = 1) -> SegmentInfo:
    """A model rank's ravel_pytree leaves (its shards at ``tp``), plus the
    padding tail as its own segment."""
    return segments_of([math.prod(s) for _, s in leaf_shapes(cfg, tp)],
                       d_pad)


def mesh_axes(mesh):
    """(dp_axes, dp_sizes, tp) of a built ``launch.mesh.DpMesh``."""
    return tuple(mesh.axes), tuple(mesh.sizes), mesh.tp


def state_layout_ctx(cfg: ArchConfig, mesh, block: int = 4096,
                     topology: str = "flat") -> StateLayout:
    """The :class:`~repro_torch.state.slots.StateLayout` of a training run
    on ``mesh`` (a ``DpMesh``): the padded flat length, the dp, server
    and pod group sizes and the segment count, as :func:`init_train_state`
    and the checkpoints size the state (``hier`` serves within the pod)."""
    dp_axes, dp_sizes, tp = mesh_axes(mesh)
    n_dp = math.prod(dp_sizes)
    d_pad = flat_dim(cfg, n_dp, block, tp)
    n_srv, n_outer = n_dp, 1
    if topology == "hier" and len(dp_axes) > 1:
        _, _, n_srv, n_outer = pod_split(dp_axes, dp_sizes)
    return StateLayout(d=d_pad, n_dp=n_dp, n_srv=n_srv, n_outer=n_outer,
                       n_segments=segment_info(cfg, d_pad, tp).n,
                       dp_sizes=dp_sizes, tp=tp)


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
                     n_inner: Optional[int] = None,
                     ctx: ParallelCtx = NO_TP,
                     seq_parallel: bool = False) -> TrainState:
    """Flat buffers, the model over them, and zeros optimizer state in
    ``layout``; under zero1 this rank's f32 master chunk starts as its
    chunk of the parameters.  ``n_dp`` counts every dp rank (the padding
    basis); ``n_inner`` is the pod size of the hierarchical topology,
    which sizes the server and cross-pod EF chunks (None = flat).
    ``ctx`` is this rank's model axis (``params`` are then its shards, as
    ``init_params(..., tp=, rank=)`` or ``convert.shard_params`` give
    them); ``seq_parallel`` runs the model with Megatron sequence
    parallelism (the reference's ``TrainStepConfig.seq_parallel``)."""
    tp = ctx.tp
    if seq_parallel:
        ctx = dataclasses.replace(ctx, sp=True)
    d = flat_size(cfg, tp)
    d_pad = flat_dim(cfg, n_dp, block, tp)
    x = flat_from_params(params, d_pad).to(device)
    g = torch.zeros_like(x)
    model = Transformer(cfg, x, ctx)
    model.bind_grads(g)
    segs = segment_info(cfg, d_pad, tp)
    opt = optimizer.init_state(d_pad, n_dp, segs.n, n_inner=n_inner,
                               layout=layout, device=device)
    ts = TrainState(model=model, x=x, g=g, opt=opt, d=d, segs=segs,
                    layout=layout)
    if layout == "zero1":
        lo, hi = _chunk(ts, n_dp,
                        dist.get_rank() // tp if n_dp > 1 else 0)
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
           accum_steps: int, overlap: Optional[_Overlap] = None,
           aux_weight: float = 0.01):
    """Fill ``ts.g`` with this rank's gradient, accumulation averaged in
    as the reference's ``_grad_tree``: the microbatch gradients summed in
    order, then divided by ``accum_steps`` (under backward overlap each
    bucket's slice divides as it is fed).  Every input (tokens, labels,
    mask, frames, patches) is cut along its batch axis.  Returns (total,
    metrics)."""
    ts.g.zero_()
    a = max(accum_steps, 1)
    b = next(iter(batch.values())).shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    mb = b // a
    total, metrics = None, None
    for i in range(a):
        with scope(FORWARD_SPAN):
            tot, met = loss_fn(ts.model, batch if a == 1 else
                               {k: v[i * mb:(i + 1) * mb]
                                for k, v in batch.items()}, aux_weight)
        last = overlap is not None and i == a - 1
        if last:
            overlap.arm()
        try:
            with scope(BACKWARD_SPAN):
                tot.backward()  # accumulates into the views of ts.g
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


def flat_grad_parts(grads, sizes: Sequence[int], d_pad: int) -> tuple:
    """Per-bucket f32 gradient parts, the backward-overlap front end of
    the reference: ``grads`` (a ``{path: tensor}`` dict, taken in ravel
    order, or a sequence of leaves in ravel order) cut at the bucket
    ``sizes`` (summing to ``d_pad``).  Each part is the concatenation of
    the raveled leaf fragments its element range covers, then zeros for
    the padding tail, so that ``torch.cat(parts)`` is bitwise the padded
    ravel and part ``b`` reads only the leaves it overlaps."""
    if isinstance(grads, dict):
        grads = [grads[p] for p, _ in ravel_shapes(grads)]
    leaves = [g.reshape(-1).to(torch.float32) for g in grads]
    d_r = sum(g.shape[0] for g in leaves)
    if sum(sizes) != d_pad or d_pad < d_r:
        raise ValueError(f"bucket sizes {tuple(sizes)} do not cover "
                         f"d_pad {d_pad} >= {d_r} gradient elements")
    parts, lo = [], 0
    for sz in sizes:
        hi, frags, a = lo + sz, [], 0
        for g in leaves:
            b = a + g.shape[0]
            if min(hi, b) > max(lo, a):
                frags.append(g[max(lo, a) - a:min(hi, b) - a])
            a = b
        n_pad = hi - max(lo, d_r)
        if n_pad > 0:
            frags.append(leaves[0].new_zeros(min(n_pad, sz)))
        parts.append(frags[0] if len(frags) == 1 else torch.cat(frags))
        lo = hi
    return tuple(parts)


def flat_grads(ts: TrainState, batch: Dict[str, torch.Tensor],
               accum_steps: int = 1, aux_weight: float = 0.01,
               bucket_sizes: Optional[Sequence[int]] = None):
    """This rank's flat f32 training-loss gradient padded to ``d_pad``,
    with its :class:`SegmentInfo` and the ``(total, metrics)`` aux: the
    front half of :func:`train_step` (the same forward, backward and
    accumulation), as the reference's ``flat_grads``.  The gradient is
    ``ts.g`` itself, which the next step overwrites.  With
    ``bucket_sizes`` the first value is the tuple of per-bucket parts
    (views of ``ts.g``, bitwise :func:`flat_grad_parts`' of the
    leaves)."""
    total, metrics = _grads(ts, batch, accum_steps, None, aux_weight)
    g = ts.g if bucket_sizes is None else \
        tuple(ts.g.split(list(bucket_sizes)))
    return g, ts.segs, total, metrics


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
               overlap_bwd: bool = False, aux_weight: float = 0.01,
               tp_axes: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """One step of ``stage`` ("warmup" | "compressed"); updates ``ts`` and
    returns the metrics (0-dim tensors): loss/aux/acc/total dp-meaned,
    ``v_l1`` (the global one: summed over the shards under zero1,
    dp-meaned under local), the other :data:`STAT_KEYS` dp-meaned.

    ``sync=False`` is a 0-bit compression-stage step (no exchange, no
    model update) and needs the ``local`` layout.  Under zero1 every step
    is a compressed update, as in the reference.  See the module doc for
    the axes, ``topology``, ``n_buckets`` and ``overlap_bwd``.
    ``aux_weight`` scales the MoE load-balance loss into the total (the
    reference's ``TrainStepConfig.aux_weight``).  ``tp_axes`` (the model
    axis, when the mesh has one above 1): the optimizer's layerwise norms
    sum over it, and ``v_l1`` is summed over the model ranks' shards; the
    other stats stay per model rank, as in the reference."""
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
    total, metrics = _grads(ts, batch, accum_steps, overlap, aux_weight)
    ts.stage0_in_bwd = overlap.early if overlap is not None else 0
    kw = dict(dp_axes=inner, pod_axes=outer, segs=ts.segs, sync=sync,
              n_buckets=n_buckets, tp_axes=tuple(tp_axes),
              exchange=overlap.ex if overlap is not None else None)
    with scope(UPDATE_SPAN):
        if sharded:
            new_x, ts.opt, stats = optimizer.update(ts.g, ts.opt, lr, **kw)
        elif stage == "warmup":
            new_x, ts.opt, stats = optimizer.warmup_update(
                ts.g, ts.opt, ts.x, lr, dp_axes=all_axes, segs=ts.segs,
                tp_axes=tuple(tp_axes))
        else:
            new_x, ts.opt, stats = optimizer.update(ts.g, ts.opt, lr,
                                                    x=ts.x, **kw)
        with torch.no_grad():
            ts.x[:ts.d].copy_(new_x[:ts.d])
    out = dict(metrics)
    out["total"] = total
    out.update({k: v for k, v in stats.items() if k != "v_l1"})
    with scope(METRICS_SPAN):
        out = _dp_mean(out, all_axes)
        v_l1 = stats["v_l1"]
        if all_axes and (sharded or ts.layout == "local"):
            v_l1, n = v_l1.clone(), comm.axis_size(all_axes)
            count_collective("all_reduce", v_l1, all_axes, n)
            dist.all_reduce(v_l1, group=group_of(all_axes))  # zero1: the sum
            if not sharded:
                v_l1 = v_l1 / n
        if tp_axes:
            v_l1 = v_l1.clone()
            count_collective("all_reduce", v_l1, tp_axes,
                             comm.axis_size(tp_axes))
            dist.all_reduce(v_l1, group=group_of(tp_axes))
    out["v_l1"] = v_l1
    return out


# --------------------------------------------------------------------------
# serving steps
# --------------------------------------------------------------------------

def make_serve_step(cfg: ArchConfig, mesh, shape: InputShape,
                    device: str = "cuda"):
    """This rank's prefill or decode step for ``shape`` on the mesh
    ``mesh`` (a ``launch.mesh.DpMesh``: dp ranks x a model axis of
    ``mesh.tp``), as the reference's ``make_serve_step``.

    ``params`` are this model rank's shards of the serving tree
    (``convert.shard_params``; the whole tree at tp = 1).  Every rank is
    given the same global batch and takes its part of it: prefill
    ``step(params, batch) -> logits`` and decode ``step(params, batch,
    caches, pos) -> (logits, caches)`` split the batch over the dp ranks
    and return this dp rank's rows, with every model rank's vocab shard
    joined: (B / n_dp, V_pad), the reference's ``out_specs=P(dp,
    model)``.  A decode batch smaller than the dp count (``long_500k``:
    one sequence) is ``seq_sharded``: every rank takes the whole batch,
    the full-attention KV caches are split along the sequence and
    combined flash-decoding style over this model rank's dp group
    (``attention.SeqGroup``); the SSM states and the windowed ring caches
    are replicated over dp.  ``step.cache_specs`` is each cache leaf's
    (dp dim, model dim) (``transformer.cache_specs``)
    and ``step.init_caches(batch=None, dtype=torch.bfloat16)`` this
    rank's slice on both axes of the reference's global zero caches, on
    the step's device (``cuda`` unless the caller asks for ``cpu``)."""
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import SeqGroup
    from repro_torch.models.common import gather_model
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"a serve step is a prefill or a decode, not "
                         f"{shape.kind!r}")
    T.check_serving(cfg)
    dev = resolve_device(device)
    n_dp, ctx = mesh.n_dp, mesh.parallel_ctx()
    group = mesh.groups.get(tuple(mesh.axes)) if n_dp > 1 else None
    rank = mesh.dp_rank
    seq_sharded = shape.kind == "decode" and shape.global_batch < n_dp

    def local(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if seq_sharded:
            return {k: v.to(dev) for k, v in batch.items()}
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n_dp:
                raise ValueError(f"a batch of {v.shape[0]} does not split "
                                 f"over {n_dp} dp ranks")
            per = v.shape[0] // n_dp
            out[k] = v[rank * per:(rank + 1) * per].to(dev)
        return out

    if shape.kind == "prefill":
        def serve_step(params, batch):
            with torch.inference_mode():
                logits = T.prefill(params, local(batch), cfg, ctx=ctx)[0]
                return gather_model(logits, ctx)
        serve_step.seq_sharded = False
        return serve_step

    seq_group = SeqGroup(group, rank, n_dp) \
        if seq_sharded and not cfg.window else None
    specs = T.cache_specs(cfg, seq_sharded)

    def serve_step(params, batch, caches, pos):
        with torch.inference_mode():
            logits, caches = T.decode_step(params, local(batch), caches,
                                           int(pos), cfg, seq_group, ctx)
            return gather_model(logits, ctx), caches

    def init_caches(batch: Optional[int] = None, dtype=torch.bfloat16):
        full = T.init_caches(cfg, batch or shape.global_batch, shape.seq_len,
                             dtype, "meta", n_dp if seq_sharded else 1,
                             mesh.tp)
        return T.shard_caches(full, specs, n_dp, mesh.tp, dev)

    serve_step.seq_sharded = seq_sharded
    serve_step.cache_specs = specs
    serve_step.init_caches = init_caches
    return serve_step
