"""Two-stage compressed-optimizer interface and registry.

Every optimizer of the family (1-bit Adam, 0/1 Adam, 1-bit LAMB) shares
one shape of algorithm:

  * **warmup stage** — an uncompressed adaptive step on the dp-mean
    gradient while the second moment ``v`` is tracked;
  * **compression stage** — ``v`` (effectively) frozen, the local momentum
    reduced across dp by the error-compensated compressed allreduce, the
    model updated by preconditioned momentum SGD.

The base class implements that skeleton once, for the ``replicated``,
``local`` and ``zero1`` state layouts, and exposes the reference's hooks
where the algorithms differ:

  ``_update_v``         variance behaviour in the compression stage
                        (frozen by default; 0/1 Adam refreshes it)
  ``_update_scale``     per-segment scaling state (1-bit LAMB freezes the
                        layerwise trust ratios here)
  ``_scale_per_elem``   how the scaling state multiplies the update
  ``_warmup_direction`` direction shaping in warmup (LAMB trust ratio)

plus the host-side ``sync_due(step)`` for optimizers that skip the
exchange on some steps (0/1 Adam's "0-bit" local steps).

State is declared once by :meth:`TwoStageOptimizer.state_slots`; the
``zero1`` layout declares ``v_shard``/``master_shard`` dp-sharded chunks
in place of ``v``, and the ONE :meth:`update` path branches on which
slots the state holds.

Per-layer information travels as a :class:`SegmentInfo` (the
``ravel_pytree`` leaf sizes, the padding tail last).  Segments are
contiguous ranges of the flat vector, so their sums are one reduction per
range (a fixed order, no atomics): the card's results are the same from
run to run, which a bitwise resume needs.

The port's copy of ``repro/optim/base.py``.  Not ported yet: the
per-bucket gradient ``parts`` and ``n_buckets`` (pipelining), ``pod_axes``
(the hierarchical topology), the audit probe; ``use_kernel`` /
``with_kernels`` have no counterpart, since the port routes by device (a
CUDA tensor takes the kernels).  The port updates nothing in place: both
stages return the new parameter vector and a new state tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.kernels.fused_adam import ops as _fused_adam
from repro_torch.optim.compressors import Compressor, OneBitCompressor
from repro_torch.plan.executor import _all_gather_into
from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     ef_errs, init_rank_state)

LAYOUTS = ("replicated", "local", "zero1")

# every update path (warmup / compressed sync / 0-bit local) emits this
# same stat set: the paper's fused-variance L1 norm (Fig. 2), the
# grad/momentum L2 norms, and the two EF-residual norms
STAT_KEYS = ("v_l1", "grad_norm", "momentum_norm", "worker_err_norm",
             "server_err_norm")


def _f32(a) -> float:
    """The f32 value a Python scalar takes when it meets an f32 array."""
    return float(np.float32(a))


@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    """Per-layer segment boundaries of the flat parameter vector.

    ``sizes`` are the ``ravel_pytree`` leaf sizes in flattening order; the
    final entry is the zero-padding tail (its own segment, so layerwise
    statistics never mix with padding).  A size may be 0: a
    :meth:`window` onto one rank's chunk keeps every segment, empty where
    the chunk does not reach it.
    """

    sizes: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def d(self) -> int:
        return sum(self.sizes)

    def ranges(self) -> Tuple[Tuple[int, int], ...]:
        out, off = [], 0
        for s in self.sizes:
            out.append((off, off + s))
            off += s
        return tuple(out)

    def window(self, lo: int, hi: int) -> "SegmentInfo":
        """The segments over the elements ``[lo, hi)`` of this vector, as
        a SegmentInfo of the slice (same ``n``, sizes clipped)."""
        return SegmentInfo(tuple(max(0, min(b, hi) - max(a, lo))
                                 for a, b in self.ranges()))

    def expand(self, per_segment: torch.Tensor) -> torch.Tensor:
        """(n,) per-segment values -> (d,) per-element values."""
        return torch.repeat_interleave(
            per_segment, torch.tensor(self.sizes,
                                      device=per_segment.device),
            output_size=self.d)


def segments_of(sizes: Sequence[int], d_pad: Optional[int] = None
                ) -> SegmentInfo:
    """SegmentInfo for parameter leaves of ``sizes`` elements (ravel
    order), with the padding to ``d_pad`` appended as a trailing
    segment."""
    sizes = [int(s) for s in sizes]
    d = sum(sizes)
    if d_pad is not None and d_pad > d:
        sizes.append(d_pad - d)
    return SegmentInfo(tuple(sizes))


def _segment_sum(x: torch.Tensor, segs: SegmentInfo,
                 axes: Sequence[str]) -> torch.Tensor:
    """Per-segment sums of ``x``, one reduction per range, summed over
    the ranks of ``axes`` when given (sharded vectors)."""
    zero = x.new_zeros(())
    s = torch.stack([x[a:b].sum() if b > a else zero
                     for a, b in segs.ranges()])
    if axes:
        dist.all_reduce(s)
    return s


def segment_norms(x: torch.Tensor, segs: SegmentInfo,
                  axes: Sequence[str] = ()) -> torch.Tensor:
    """Per-segment L2 norms of a flat (possibly sharded) vector; squared
    sums are summed over ``axes`` before the sqrt, so sharded layouts get
    the global norm."""
    return torch.sqrt(_segment_sum(torch.square(x), segs, axes))


def segment_l1(x: torch.Tensor, segs: SegmentInfo,
               axes: Sequence[str] = ()) -> torch.Tensor:
    """Per-segment L1 mass (the per-layer slice of the paper's fused
    ``||v||_1``), summed over ``axes`` when given."""
    return _segment_sum(torch.abs(x), segs, axes)


@dataclasses.dataclass(frozen=True)
class TwoStageOptimizer:
    """Base: exactly 1-bit Adam (Alg. 1) unless a hook is overridden."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = False       # BertAdam disables it (paper setup)
    compressor: Compressor = OneBitCompressor()

    name: str = "?"

    # --- declared state ----------------------------------------------------
    def state_slots(self, layout: str = "replicated"
                    ) -> Tuple[SlotSpec, ...]:
        """The family's state, declared once.

        ``layout``: ``replicated`` (paper), ``local`` (per-dp-rank
        m/v/scale, required when ``sync_due`` can skip), ``zero1`` (``v``
        and f32 master weights dp-sharded).  EF slots are identical across
        layouts: error state is inherently per-worker."""
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
        adaptive = "per_dp_rank" if layout == "local" else "replicated"
        slots = [SlotSpec("m", "per_param", "replicated"
                          if layout != "local" else "per_dp_rank")]
        if layout == "zero1":
            slots += [SlotSpec("v_shard", "per_chunk", "dp_sharded",
                               chunk_of="dp"),
                      SlotSpec("master_shard", "per_chunk", "dp_sharded",
                               chunk_of="dp")]
        else:
            slots += [SlotSpec("v", "per_param", adaptive)]
        slots += [
            SlotSpec("worker_err", "per_param", "per_dp_rank",
                     ef="worker"),
            SlotSpec("server_err", "per_chunk", "per_dp_rank",
                     chunk_of="server", ef="server", bucket_keyed=True),
            SlotSpec("scale", "per_segment", adaptive),
            SlotSpec("count", "scalar", dtype="int32"),
            SlotSpec("v_step", "scalar", dtype="int32"),
            # the hierarchical schedule's cross-pod EF slots: declared
            # unconditionally, as the reference does, so the state schema
            # and checkpoints do not depend on the compressor or topology
            # (untouched zeros on the flat topology)
            SlotSpec("outer_err", "per_chunk", "per_dp_rank",
                     chunk_of="server", ef="outer", bucket_keyed=True),
            SlotSpec("outer_ag_err", "per_chunk", "per_dp_rank",
                     chunk_of="total", ef="outer_ag", bucket_keyed=True),
        ]
        return tuple(slots)

    def init_state(self, d: int, n_dp: int = 1, n_segments: int = 1,
                   n_inner: Optional[int] = None,
                   layout: str = "replicated", device="cpu") -> StateTree:
        """Zeros per-rank state for a ``d``-element exchange over ``n_dp``
        ranks, built from :meth:`state_slots`."""
        n = max(n_dp, 1)
        n_srv = max(n_inner or n, 1)
        ctx = StateLayout(d=d, n_dp=n, n_srv=n_srv,
                          n_outer=max(n // n_srv, 1),
                          n_segments=max(n_segments, 1))
        return init_rank_state(self.state_slots(layout), ctx, device)

    @staticmethod
    def _stats(v_l1, grad_norm, momentum_norm, state=None,
               worker_err=None, server_err=None) -> Dict[str, torch.Tensor]:
        """The uniform :data:`STAT_KEYS` dict.  EF-residual norms come from
        the freshly produced errs when given, else from ``state`` (warmup
        and 0-bit steps carry the slots unchanged)."""
        we = worker_err if worker_err is not None else state.worker_err
        se = server_err if server_err is not None else state.server_err
        return {"v_l1": v_l1, "grad_norm": grad_norm,
                "momentum_norm": momentum_norm,
                "worker_err_norm": torch.linalg.vector_norm(we),
                "server_err_norm": torch.linalg.vector_norm(se)}

    # --- hooks (the whole per-algorithm surface) ---------------------------
    def _update_v(self, v: torch.Tensor, v_step: torch.Tensor,
                  m_prev: torch.Tensor, m_bar: torch.Tensor,
                  count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compression-stage variance; returns (v, new v_step marker).
        Default: frozen (Alg. 1).  Called on SYNC steps only: what feeds
        ``v`` must be the same on every dp rank."""
        return v, v_step

    def _update_scale(self, scale: torch.Tensor, x: torch.Tensor,
                      upd: torch.Tensor, segs: Optional[SegmentInfo],
                      norm_axes: Sequence[str]) -> torch.Tensor:
        """Per-segment scaling state.  Default: untouched.  ``segs``
        covers exactly the elements of ``x``/``upd`` (a window of the
        full vector under zero1)."""
        return scale

    def _scale_per_elem(self, scale: torch.Tensor,
                        segs: Optional[SegmentInfo]
                        ) -> Optional[torch.Tensor]:
        """Per-element multiplier from the scaling state; None = identity
        (skipped, keeping the default path bitwise 1-bit Adam)."""
        return None

    def _warmup_direction(self, upd: torch.Tensor, x: torch.Tensor,
                          segs: Optional[SegmentInfo],
                          norm_axes: Sequence[str]) -> torch.Tensor:
        """Warmup direction shaping.  Default: plain Adam direction."""
        return upd

    def sync_due(self, step: int) -> bool:
        """Host-side: must step ``step`` of the compression stage
        synchronise across dp?  Default: every step (1-bit Adam)."""
        return True

    @property
    def may_skip_sync(self) -> bool:
        """True if ``sync_due`` can ever return False: callers must then
        use the per-dp-rank ("local") state layout."""
        return False

    @property
    def _fused_warmup_ok(self) -> bool:
        """The fused Adam kernel computes the base warmup update exactly:
        usable iff no hook reshapes the direction and bias correction is
        off (the kernel implements BertAdam).  The reference also needs
        its ``use_kernel`` flag; the port routes by device instead (a CUDA
        tensor takes the kernel, a CPU tensor its plain version)."""
        return (not self.bias_correction
                and type(self)._warmup_direction
                is TwoStageOptimizer._warmup_direction)

    # --- warmup stage ------------------------------------------------------
    def warmup_update(self, g_local: torch.Tensor, state: StateTree,
                      x: torch.Tensor, lr: float, *,
                      dp_axes: Sequence[str] = (),
                      segs: Optional[SegmentInfo] = None,
                      ) -> Tuple[torch.Tensor, StateTree, dict]:
        """Uncompressed adaptive step on the dp-mean gradient; with
        :attr:`_fused_warmup_ok` the whole elementwise update is ONE fused
        op (``kernels/fused_adam``: the Hopper kernel on CUDA tensors)."""
        g = comm.allreduce_mean(g_local, dp_axes)
        count = state.count + 1
        lr = _f32(lr)
        if self._fused_warmup_ok:
            new_x, m, v = _fused_adam.adam_step(
                x, state.m, state.v, g, lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay)
        else:
            m = self.b1 * state.m + (1.0 - self.b1) * g
            v = self.b2 * state.v + (1.0 - self.b2) * torch.square(g)
            if self.bias_correction:
                t = count.to(torch.float32)
                m_hat = m / (1.0 - self.b1 ** t)
                v_hat = v / (1.0 - self.b2 ** t)
            else:
                m_hat, v_hat = m, v
            upd = m_hat / (torch.sqrt(v_hat) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * x
            upd = self._warmup_direction(upd, x, segs, ())
            new_x = x - lr * upd
        stats = self._stats(v_l1=v.abs().sum(),
                            grad_norm=torch.linalg.vector_norm(g),
                            momentum_norm=torch.linalg.vector_norm(m),
                            state=state)
        return new_x, state._replace(m=m, v=v, count=count), stats

    # --- compression stage (ONE path, parameterised by the slots) ----------
    def update(self, g_local: torch.Tensor, state: StateTree, lr: float,
               *, x: Optional[torch.Tensor] = None,
               dp_axes: Sequence[str] = (),
               segs: Optional[SegmentInfo] = None,
               sync: bool = True) -> Tuple[torch.Tensor, StateTree, dict]:
        """Compressed (or, with ``sync=False``, purely local) momentum
        step preconditioned by the (hook-governed) second moment.

        A ``v`` slot means the replicated/local layout (``x`` required;
        the new full parameter vector is returned); ``v_shard`` /
        ``master_shard`` mean ZeRO-1 (``x`` ignored: the update lands on
        this rank's f32 master chunk, and the bf16 replica gathered from
        every rank's chunk is returned).  The EF slot dict handed to the
        exchange is read off the declared ``ef=`` fields.

        A ``sync=False`` ("0-bit") step moves no bytes and applies no
        model update: the local gradient folds into the per-rank momentum,
        and the next synchronised step applies the dp-mean EMA of every
        gradient seen since the last sync, so the parameters stay the same
        on every dp rank while the per-rank momentum diverges (hence the
        ``local`` layout)."""
        sharded = "master_shard" in state
        lr = _f32(lr)
        m_local = self.b1 * state.m + (1.0 - self.b1) * g_local
        if not sync:
            x_full = self._full_params(state, x, dp_axes)
            stats = self._stats(
                v_l1=(state.v_shard if sharded else state.v).abs().sum(),
                grad_norm=torch.linalg.vector_norm(g_local),
                momentum_norm=torch.linalg.vector_norm(m_local),
                state=state)
            return x_full, state._replace(m=m_local,
                                          count=state.count + 1), stats

        ef_slots = tuple(s for s in self.state_slots(
            "zero1" if sharded else "replicated")
            if s.ef is not None and s.name in state)
        m_bar, errs = comm.compressed_exchange(
            m_local, ef_errs(state, ef_slots), dp_axes, self.compressor)
        count = state.count + 1

        if sharded:
            n = comm.axis_size(dp_axes)
            chunk = m_bar.shape[0] // max(n, 1)
            lo = dist.get_rank() * chunk if dp_axes else 0
            my_mbar = m_bar[lo:lo + chunk]
            v, v_step = self._update_v(state.v_shard, state.v_step,
                                       state.m[lo:lo + chunk], my_mbar,
                                       count)
            upd = my_mbar / (torch.sqrt(v) + self.eps)
            master = state.master_shard
            if segs is not None:
                segs = segs.window(lo, lo + chunk)
            # each rank holds one chunk: segment norms sum over dp
            norm_axes = tuple(dp_axes)
        else:
            if x is None:
                raise ValueError("update() needs x for the replicated and "
                                 "local layouts")
            v, v_step = self._update_v(state.v, state.v_step, state.m,
                                       m_bar, count)
            upd = m_bar / (torch.sqrt(v) + self.eps)
            master = x
            norm_axes = ()

        scale = self._update_scale(state.scale, master, upd, segs,
                                   norm_axes)
        pe = self._scale_per_elem(scale, segs)
        if pe is not None:
            upd = upd * pe
        if self.weight_decay:
            upd = upd + self.weight_decay * master
        new_master = master - lr * upd

        repl = {s.name: errs[s.ef] for s in ef_slots}
        repl.update(m=m_bar, scale=scale, count=count, v_step=v_step)
        if sharded:
            repl.update(v_shard=v, master_shard=new_master)
            x_full = self._gather_replica(new_master, dp_axes)
        else:
            repl.update(v=v)
            x_full = new_master
        stats = self._stats(v_l1=v.abs().sum(),
                            grad_norm=torch.linalg.vector_norm(g_local),
                            momentum_norm=torch.linalg.vector_norm(m_bar),
                            worker_err=errs["worker"],
                            server_err=errs["server"])
        return x_full, state._replace(**repl), stats

    @staticmethod
    def _gather_replica(master_shard: torch.Tensor,
                        dp_axes: Sequence[str]) -> torch.Tensor:
        """The bf16 parameter replica: every rank's master chunk, rounded
        to bf16, gathered in rank order."""
        shard = master_shard.to(torch.bfloat16)
        if not dp_axes:
            return shard
        n = comm.axis_size(dp_axes)
        out = torch.empty((n * shard.shape[0],), dtype=shard.dtype,
                          device=shard.device)
        _all_gather_into(out, shard)
        return out

    def _full_params(self, state: StateTree, x,
                     dp_axes: Sequence[str]) -> torch.Tensor:
        if "master_shard" in state:
            return self._gather_replica(state.master_shard, dp_axes)
        if x is None:
            raise ValueError("update() needs x for the replicated and local "
                             "layouts")
        return x


_OPTIMIZERS: Dict[str, Callable[..., TwoStageOptimizer]] = {}


def register_optimizer(name: str):
    def deco(cls):
        _OPTIMIZERS[name] = cls
        return cls
    return deco


def get_optimizer(name: str, *, compressor="onebit",
                  compressor_kwargs: Optional[dict] = None,
                  **hyper) -> TwoStageOptimizer:
    """Build a registered optimizer, resolving the compressor by name (or
    accepting a ready :class:`Compressor` / ``CompressionConfig``)."""
    from repro_torch.optim.compressors import as_compressor, get_compressor
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"registered: {sorted(_OPTIMIZERS)}")
    if isinstance(compressor, str):
        comp = get_compressor(compressor, **(compressor_kwargs or {}))
    else:
        comp = as_compressor(compressor)
    return _OPTIMIZERS[name](compressor=comp, **hyper)


def list_optimizers():
    return sorted(_OPTIMIZERS)
