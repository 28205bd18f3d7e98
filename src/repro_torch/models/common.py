"""Tensor-parallel context, the Megatron collectives, and shared layers.

The model code runs per rank: each model rank holds its shard of every
parameter the reference shards over the ``model`` axis, and the
collectives that join the shards are placed by hand, each with its
hand-written transpose (a ``torch.autograd.Function``), as the reference's
``custom_vjp``s:

  ``g_copy``        identity fwd / all-reduce bwd (Megatron's g: where a
                    replicated activation enters column-parallel compute)
  ``f_reduce``      all-reduce fwd / identity bwd (Megatron's f-bar:
                    closes a row-parallel matmul)
  ``rep_param``     a parameter replicated over the model axis (norm
                    scales, routers): identity under TP, all-reduce of its
                    gradient under SP
  ``grouped_param`` a parameter duplicated over groups of ``rep`` model
                    ranks (kv projections when n_kv_heads < tp): gradient
                    all-reduced within the group
  ``sp_gather`` / ``sp_scatter``  the sequence-parallel boundary pair:
                    all-gather fwd / reduce-scatter bwd along the sequence,
                    and the reverse
  ``sp_slice``      this rank's chunk of a replicated sequence
  ``pmean``         mean over the model axis, all-reduce / tp both ways

A forward all-reduce works on a copy, never on a tensor autograd saved.
With ``ParallelCtx()`` (one model rank) every collective is the identity,
so the same model code runs at tp = 1 and under any mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.obs.trace import count_collective

# the mesh axis of tensor parallelism (``launch.mesh`` builds its group);
# every collective here runs on it or on a kv-duplicate subgroup of it
MODEL_AXIS = "model"
_MODEL = (MODEL_AXIS,)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """This rank's view of the model axis.

    ``group``: the model axis's process group (None: the default group);
    ``tp``: its rank count (1: no tensor parallelism, every collective
    the identity); ``sp``: Megatron sequence parallelism (the residual
    stream between blocks split along the sequence over the model ranks);
    ``kv_groups``: ``(rep, group)`` pairs, this rank's group of ``rep``
    contiguous model ranks for every ``rep`` that divides ``tp`` (the
    kv-duplicate groups; ``launch.mesh.build_mesh`` makes them once)."""

    group: Optional[object] = None
    tp: int = 1
    sp: bool = False
    kv_groups: Tuple[Tuple[int, object], ...] = ()

    def kv_group(self, rep: int):
        """The process group of this rank's ``rep`` duplicate ranks."""
        if rep == self.tp:
            return self.group
        for r, g in self.kv_groups:
            if r == rep:
                return g
        raise KeyError(f"no kv-duplicate group of {rep} ranks on a model "
                       f"axis of {self.tp} (build_mesh makes them)")


NO_TP = ParallelCtx()


def _all_reduce(x: torch.Tensor, group, n: int, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """The all-reduce of a contiguous copy of ``x`` over the ``n`` ranks
    of ``group``."""
    y = x.clone(memory_format=torch.contiguous_format)
    count_collective("all_reduce", y, _MODEL, n)
    dist.all_reduce(y, op=op, group=group)
    return y


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    count_collective("all_gather_into_tensor", xt, _MODEL, n)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's chunk along ``dim``."""
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    count_collective("reduce_scatter_tensor", xt, _MODEL, n)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


class _GCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group, ctx.n), None, None


class _FReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group, n)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_reduce(x, group, n) / n

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group, ctx.n) / ctx.n, None, None


class _SpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, ct):
        return _scatter(ct, ctx.group, ctx.n, ctx.dim), None, None, None


class _SpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, ct):
        return _gather(ct, ctx.group, ctx.n, ctx.dim), None, None, None


def g_copy(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Identity fwd; bwd sums the gradient over the model axis."""
    if ctx.tp == 1:
        return x
    return _GCopy.apply(x, ctx.group, ctx.tp)


def f_reduce(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Sum over the model axis fwd; identity bwd."""
    if ctx.tp == 1:
        return x
    return _FReduce.apply(x, ctx.group, ctx.tp)


def pmean(x: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """Mean over the model axis; the cotangent is averaged the same way
    (the reference's ``pmean`` under ``shard_map``)."""
    if ctx.tp == 1:
        return x
    return _PMean.apply(x, ctx.group, ctx.tp)


def rep_param(w: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """A parameter replicated over the model axis (norm scales, routers).

    Under TP (``ctx.sp`` False) its gradient takes NO all-reduce: every
    consumer of a replicated activation enters sharded compute through
    ``g_copy``, whose backward already made the residual stream's
    cotangent complete and the same on every model rank; summing again
    would count it tp times.  Under SP every rank holds its own tokens, so
    each rank's gradient is partial and the all-reduce is needed."""
    if ctx.tp == 1 or not ctx.sp:
        return w
    return _GCopy.apply(w, ctx.group, ctx.tp)


def grouped_param(w: torch.Tensor, ctx: ParallelCtx, rep: int
                  ) -> torch.Tensor:
    """A parameter duplicated over contiguous groups of ``rep`` model ranks
    (kv projections when n_kv_heads < tp): its gradient is summed within
    the group, so the copies stay equal."""
    if ctx.tp == 1 or rep <= 1:
        return w
    return _GCopy.apply(w, ctx.kv_group(rep), rep)


def tp_rank(ctx: ParallelCtx) -> int:
    """This rank's index on the model axis (0 without TP)."""
    return dist.get_rank(ctx.group) if ctx.tp > 1 else 0


def gather_model(x: torch.Tensor, ctx: ParallelCtx, dim: int = -1
                 ) -> torch.Tensor:
    """Every model rank's ``x`` joined along ``dim`` in rank order, forward
    only (the serving steps' vocab-sharded logits)."""
    if ctx.tp == 1:
        return x
    return _gather(x, ctx.group, ctx.tp, dim)


def sp_gather(x: torch.Tensor, ctx: ParallelCtx, dim: int = 1
              ) -> torch.Tensor:
    """(..., S/tp, ...) -> (..., S, ...): all-gather fwd, reduce-scatter
    bwd."""
    if ctx.tp == 1:
        return x
    return _SpGather.apply(x, ctx.group, ctx.tp, dim)


def sp_scatter(x: torch.Tensor, ctx: ParallelCtx, dim: int = 1
               ) -> torch.Tensor:
    """Partial (..., S, ...) -> summed (..., S/tp, ...): reduce-scatter fwd,
    all-gather bwd.  Takes f_reduce's place at a sequence-parallel
    boundary: the same sum, half the wire bytes."""
    if ctx.tp == 1:
        return x
    return _SpScatter.apply(x, ctx.group, ctx.tp, dim)


def sp_slice(x: torch.Tensor, ctx: ParallelCtx, dim: int = 1
             ) -> torch.Tensor:
    """This rank's chunk of the sequence of a replicated tensor."""
    if ctx.tp == 1:
        return x
    size = x.shape[dim] // ctx.tp
    return x.narrow(dim, tp_rank(ctx) * size, size)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """Variance in f32; the product is taken before the cast back."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings at ``positions`` (..., S):
    returns cos, sin of shape (..., S, head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: bf16 operands accumulate in f32 (cuBLAS), then
    the result is rounded to x's dtype, as the reference's
    ``preferred_element_type=f32`` einsum followed by the cast."""
    return torch.matmul(x, w.to(x.dtype))


# The products whose outputs ``remat_policy="dots"`` keeps: a 2-D product
# has no batch dimension (``dense`` folds (..., d) @ (d, f) into one ``mm``,
# as do the router and the MoE's one-hot dispatch and combine), while the
# attention products and the SSM's contraction are ``bmm``s over batch
# dimensions and are recomputed, as in the reference.
SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``remat_policy="dots"`` (the
    reference's ``dots_with_no_batch_dims_saveable``): keep the output of
    every product without batch dimensions, recompute everything else,
    the collectives included."""
    if func in SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                scale: Optional[float] = None) -> torch.Tensor:
    """A (d_in, d_out) f32 weight, N(0, scale^2) with scale 1/sqrt(d_in)
    by default (the reference's ``init_linear``; ``init_params`` draws
    the stacked leaves with the same law)."""
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn((d_in, d_out), generator=generator,
                       device=generator.device) * scale


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dim: the output has
    ceil(size / stride) positions and the odd pixel goes to the high side,
    so a 3 x 3 stride-2 conv pads (0, 1) on an even size, where
    ``F.conv2d(padding=1)`` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """NCHW conv with an HWIO weight (the reference's leaf layout) and
    SAME padding: ``lax.conv_general_dilated(..., padding="SAME",
    dimension_numbers=("NHWC", "HWIO", "NHWC"))`` in NCHW."""
    kh, kw = w.shape[:2]
    ph = same_padding(x.shape[2], kh, stride)
    pw = same_padding(x.shape[3], kw, stride)
    x = torch.nn.functional.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1),
                                      stride=stride)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The reference's NHWC group norm on NCHW: ``min(groups, C)``
    contiguous channel groups, population variance, ``eps`` inside the
    rsqrt, then a per-channel scale and bias."""
    return torch.nn.functional.group_norm(x, min(groups, x.shape[1]),
                                          scale, bias, eps)


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """TF32 off for cuBLAS matmuls and cuDNN convs (torch's cuDNN default
    would run the f32 convs in TF32) while the block runs; the flags as
    they were on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
