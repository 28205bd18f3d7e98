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

The port's copy of ``repro/optim/base.py``, with ``pod_axes`` (the
hierarchical topology), ``n_buckets`` (the pipelined exchange) and
backward overlap's exchange fed bucket by bucket (``start_exchange`` /
``fold_momentum``; the reference's tuple of gradient parts has no other
user, so ``update`` takes the full vector), and the audit hooks that
``repro_torch.obs.audit`` reads (:meth:`TwoStageOptimizer.audit_stats`,
``_audit_extra`` / ``audit_extra_keys`` / ``_audit_v_live``).
``use_kernel`` / ``with_kernels`` have no counterpart, since the port
routes by device (a CUDA tensor takes the kernels).  The port
updates nothing in place: both stages return the new parameter vector
and a new state tree.
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
from repro_torch.plan.executor import all_gather_into, group_of
from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     ef_errs, init_rank_state)

LAYOUTS = ("replicated", "local", "zero1")

# every update path (warmup / compressed sync / 0-bit local) emits this
# same stat set: the paper's fused-variance L1 norm (Fig. 2), the
# grad/momentum L2 norms, and the two EF-residual norms
STAT_KEYS = ("v_l1", "grad_norm", "momentum_norm", "worker_err_norm",
             "server_err_norm")

# the audit probe's stat set (repro_torch.obs.audit): per-segment vectors
# of length SegmentInfo.n, then whole-model scalars; optimizers may append
# per-family extras via ``audit_extra_keys`` / ``_audit_extra``
AUDIT_SEG_KEYS = ("cos_sim", "sign_agree", "v_drift", "v_l1_seg",
                  "worker_err_seg", "server_err_seg")
AUDIT_SCALAR_KEYS = ("v_ratio", "grad_norm", "momentum_norm",
                     "worker_err_norm", "server_err_norm", "v_live")


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
        dist.all_reduce(s, group=group_of(axes))
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


def segment_cosine(a: torch.Tensor, b: torch.Tensor, segs: SegmentInfo,
                   axes: Sequence[str] = ()) -> torch.Tensor:
    """Per-segment cosine similarity ``<a,b> / (||a|| ||b||)``; the three
    inner products are summed over ``axes`` before the division, so
    sharded vectors get the global similarity.  Segments where either
    side is all zero report 1.0 (nothing was lost)."""
    dots = _segment_sum(a * b, segs, axes)
    na = _segment_sum(torch.square(a), segs, axes)
    nb = _segment_sum(torch.square(b), segs, axes)
    denom = torch.sqrt(na * nb)
    return torch.where(denom > 0.0, dots / torch.clamp(denom, min=1e-30),
                       torch.ones_like(denom))


def segment_sign_agreement(a: torch.Tensor, b: torch.Tensor,
                           segs: SegmentInfo, axes: Sequence[str] = ()
                           ) -> torch.Tensor:
    """Per-segment fraction of coordinates where ``sign(a) == sign(b)``
    (what 1-bit compression preserves when EF is healthy); counts are
    summed over ``axes``.  Empty segments report 1.0."""
    agree = (torch.sign(a) == torch.sign(b)).to(torch.float32)
    num = _segment_sum(agree, segs, axes)
    cnt = torch.tensor([float(s) for s in segs.sizes], device=a.device)
    if axes:
        dist.all_reduce(cnt, group=group_of(axes))
    return torch.where(cnt > 0.0, num / torch.clamp(cnt, min=1.0),
                       torch.ones_like(cnt))


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

    # --- audit hooks (repro_torch.obs.audit reads these) -------------------
    def _audit_extra(self, state: StateTree, segs: SegmentInfo) -> dict:
        """Per-family additions to :meth:`audit_stats` (keys must match
        :attr:`audit_extra_keys`).  Default: none."""
        return {}

    @property
    def audit_extra_keys(self) -> Tuple[str, ...]:
        """Names of the extra stats :meth:`_audit_extra` returns."""
        return ()

    def _audit_v_live(self, state: StateTree) -> torch.Tensor:
        """1.0 while the compression-stage variance is still legitimately
        updating (0/1 Adam's interval refresh), 0.0 once frozen — the
        HealthMonitor suppresses the variance-drift verdict while live.
        Default: frozen (Alg. 1)."""
        return torch.zeros((), dtype=torch.float32, device=state.m.device)

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
    def _ef_slots(self, state: StateTree) -> Tuple[SlotSpec, ...]:
        """The declared EF slots ``state`` holds (EF slots are the same in
        every layout, so any layout's declaration serves)."""
        layout = "zero1" if "master_shard" in state else "replicated"
        return tuple(s for s in self.state_slots(layout)
                     if s.ef is not None and s.name in state)

    def fold_momentum(self, state: StateTree, lo: int,
                      g_part: torch.Tensor) -> torch.Tensor:
        """The local momentum of the elements ``[lo, lo + len(g_part))``:
        elementwise, so bitwise that slice of the full-vector fold."""
        m_prev = state.m[lo:lo + g_part.shape[0]]
        return self.b1 * m_prev + (1.0 - self.b1) * g_part

    def start_exchange(self, state: StateTree, *,
                       dp_axes: Sequence[str] = (),
                       pod_axes: Sequence[str] = (), n_buckets: int = 1,
                       order_of=None):
        """The pipelined momentum exchange of ``state``'s next sync step as
        a :class:`~repro_torch.pipeline.Wavefront` for backward overlap
        (fed bucket by bucket with :meth:`fold_momentum`, then handed to
        :meth:`update` as ``exchange``; ``order_of`` as in
        :func:`repro_torch.core.comm.start_exchange`); None when there is
        one bucket."""
        return comm.start_exchange(
            state.m.shape[0], ef_errs(state, self._ef_slots(state)),
            dp_axes, pod_axes, self.compressor, n_buckets, order_of)

    def update(self, g_local: torch.Tensor, state: StateTree, lr: float,
               *, x: Optional[torch.Tensor] = None,
               dp_axes: Sequence[str] = (),
               pod_axes: Sequence[str] = (),
               segs: Optional[SegmentInfo] = None,
               sync: bool = True, n_buckets: int = 1,
               exchange=None) -> Tuple[torch.Tensor, StateTree, dict]:
        """Compressed (or, with ``sync=False``, purely local) momentum
        step preconditioned by the (hook-governed) second moment.

        A ``v`` slot means the replicated/local layout (``x`` required;
        the new full parameter vector is returned); ``v_shard`` /
        ``master_shard`` mean ZeRO-1 (``x`` ignored: the update lands on
        this rank's f32 master chunk, and the bf16 replica gathered from
        every rank's chunk is returned).  The EF slot dict handed to the
        exchange is read off the declared ``ef=`` fields.

        With ``pod_axes`` the exchange runs the hierarchical schedule
        (``dp_axes`` within the pod, ``pod_axes`` across pods);
        ``n_buckets > 1`` runs it through the pipelined executor, bitwise
        the serial one.  ``exchange`` is a wavefront from
        :meth:`start_exchange` that backward overlap has fed every bucket
        of (each folded by :meth:`fold_momentum`); ``g_local`` is then
        read for the stats only.

        A ``sync=False`` ("0-bit") step moves no bytes and applies no
        model update: the local gradient folds into the per-rank momentum,
        and the next synchronised step applies the dp-mean EMA of every
        gradient seen since the last sync, so the parameters stay the same
        on every dp rank while the per-rank momentum diverges (hence the
        ``local`` layout)."""
        sharded = "master_shard" in state
        all_axes = tuple(pod_axes) + tuple(dp_axes)
        lr = _f32(lr)
        if not sync:
            m_local = self.b1 * state.m + (1.0 - self.b1) * g_local
            x_full = self._full_params(state, x, all_axes)
            stats = self._stats(
                v_l1=(state.v_shard if sharded else state.v).abs().sum(),
                grad_norm=torch.linalg.vector_norm(g_local),
                momentum_norm=torch.linalg.vector_norm(m_local),
                state=state)
            return x_full, state._replace(m=m_local,
                                          count=state.count + 1), stats

        ef_slots = self._ef_slots(state)
        if exchange is not None:
            m_bar, errs = exchange.finish()
        else:
            m_local = self.b1 * state.m + (1.0 - self.b1) * g_local
            m_bar, errs = comm.compressed_exchange(
                m_local, ef_errs(state, ef_slots), dp_axes, pod_axes,
                self.compressor, n_buckets=n_buckets)
            del m_local
        count = state.count + 1

        if sharded:
            n = comm.axis_size(all_axes)
            chunk = m_bar.shape[0] // max(n, 1)
            lo = comm.axis_index(all_axes) * chunk
            my_mbar = m_bar[lo:lo + chunk]
            v, v_step = self._update_v(state.v_shard, state.v_step,
                                       state.m[lo:lo + chunk], my_mbar,
                                       count)
            upd = my_mbar / (torch.sqrt(v) + self.eps)
            master = state.master_shard
            if segs is not None:
                segs = segs.window(lo, lo + chunk)
            # each rank holds one chunk: segment norms sum over dp
            norm_axes = all_axes
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
            x_full = self._gather_replica(new_master, all_axes)
        else:
            repl.update(v=v)
            x_full = new_master
        stats = self._stats(v_l1=v.abs().sum(),
                            grad_norm=torch.linalg.vector_norm(g_local),
                            momentum_norm=torch.linalg.vector_norm(m_bar),
                            worker_err=errs["worker"],
                            server_err=errs["server"])
        return x_full, state._replace(**repl), stats

    # --- audit probe (observation only; repro_torch.obs.audit builds it) ---
    def audit_stats(self, g_local: torch.Tensor, state: StateTree,
                    shadow_v: torch.Tensor, *,
                    dp_axes: Sequence[str] = (),
                    pod_axes: Sequence[str] = (),
                    segs: Optional[SegmentInfo] = None,
                    ) -> Tuple[torch.Tensor, dict]:
        """Per-segment compression-fidelity and frozen-variance stats of
        one WOULD-BE sync step — pure observation: the state and the EF
        residuals are read, never written.  The compressor gets fresh
        buffers (no ``out=``), never the state's ``worker_err`` or
        ``server_err`` to write into, so the audit cannot change training.

        Returns ``(new_shadow_v, stats)``:

          * ``new_shadow_v`` — the shadow second-moment EMA advanced one
            step on the dp-mean gradient: what ``v`` would be were it not
            frozen (the paper's Sec. 7.1 / Fig. 2 quantity, per segment);
          * ``stats`` — the :data:`AUDIT_SEG_KEYS` per-segment vectors,
            the :data:`AUDIT_SCALAR_KEYS` scalars and any
            ``audit_extra_keys`` of the family.

        Fidelity is measured on what a sync step compresses: the
        EF-compensated local momentum ``m_local + worker_err`` against
        its decompressed wire image.  Needs the full ``v`` slot (the
        replicated and local layouts; zero1 shards it)."""
        if "v" not in state:
            raise ValueError("audit_stats needs the full 'v' slot (the "
                             "replicated or local layout), not zero1's "
                             "v_shard")
        all_dp = tuple(pod_axes) + tuple(dp_axes)
        if segs is None:
            segs = SegmentInfo((g_local.shape[0],))

        # (a) frozen-variance validity: one shadow-EMA step on the dp-mean
        # gradient, compared per segment against the frozen v
        g = comm.allreduce_mean(g_local, all_dp)
        new_sv = self.b2 * shadow_v + (1.0 - self.b2) * torch.square(g)
        sv_seg = segment_l1(new_sv, segs)
        v_seg = segment_l1(state.v, segs)
        one = torch.ones((), device=v_seg.device)
        # zero-mass segments (the padding tail, untouched layers) have no
        # drift to report: ratio pinned to 1.0, not 0/0
        v_drift = torch.where(v_seg > 0.0,
                              sv_seg / torch.clamp(v_seg, min=1e-30), one)
        v_tot, sv_tot = torch.sum(v_seg), torch.sum(sv_seg)
        v_ratio = torch.where(v_tot > 0.0,
                              sv_tot / torch.clamp(v_tot, min=1e-30), one)

        # (b) compression fidelity of the would-be momentum exchange
        m_local = self.b1 * state.m + (1.0 - self.b1) * g_local
        raw = m_local + state.worker_err
        payload, _ = self.compressor.ef_compress(m_local, state.worker_err)
        m_hat = self.compressor.decompress(payload)
        cos = segment_cosine(raw, m_hat, segs)
        sign = segment_sign_agreement(raw, m_hat, segs)
        if all_dp:   # per-rank quantities: report the dp mean
            cos = comm.allreduce_mean(cos, all_dp)
            sign = comm.allreduce_mean(sign, all_dp)

        # EF-residual mass per segment: global L2 over every rank's
        # residual
        we_seg = segment_norms(state.worker_err, segs, all_dp)
        # the server residual is one chunk per intra-pod rank at that
        # rank's element offset (the all_to_all partition)
        chunk = state.server_err.shape[0]
        off = comm.axis_index(dp_axes) * chunk if dp_axes else 0
        se_seg = segment_norms(state.server_err,
                               segs.window(off, off + chunk), all_dp)

        m_norm = torch.linalg.vector_norm(m_local)
        stats = {
            "cos_sim": cos, "sign_agree": sign, "v_drift": v_drift,
            "v_l1_seg": v_seg, "worker_err_seg": we_seg,
            "server_err_seg": se_seg,
            "v_ratio": v_ratio,
            "grad_norm": torch.linalg.vector_norm(g),
            "momentum_norm": (comm.allreduce_mean(m_norm.reshape(1),
                                                  all_dp)[0]
                              if all_dp else m_norm),
            "worker_err_norm": torch.sqrt(torch.sum(torch.square(we_seg))),
            "server_err_norm": torch.sqrt(torch.sum(torch.square(se_seg))),
            "v_live": self._audit_v_live(state),
        }
        stats.update(self._audit_extra(state, segs))
        return new_sv, stats

    @staticmethod
    def _gather_replica(master_shard: torch.Tensor,
                        dp_axes: Sequence[str]) -> torch.Tensor:
        """The bf16 parameter replica: every rank's master chunk, rounded
        to bf16, gathered in rank order over ``dp_axes`` (all of them:
        the pod axes lead)."""
        shard = master_shard.to(torch.bfloat16)
        if not dp_axes:
            return shard
        n = comm.axis_size(dp_axes)
        out = torch.empty((n * shard.shape[0],), dtype=shard.dtype,
                          device=shard.device)
        all_gather_into(out, shard, group=group_of(dp_axes))
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
