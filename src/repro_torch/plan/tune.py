"""Cluster auto-tuner: pick the cheapest valid collective schedule.

``autotune`` enumerates (topology x compressor x block_size x n_buckets
x use_kernel x overlap) for a :class:`~repro_torch.plan.cost.ClusterSpec`
and a flat model dimension, prices every candidate with the α-β model
(pipelined pricing when ``n_buckets > 1``), and returns the cheapest
valid one.  With ``price_compute=True`` (the default) each candidate's
compress/EF/decompress compute is rooflined against ``spec.device`` and
folded into the price: serially for unpipelined plans, as an overlapping
stream for pipelined ones.

The kernel axis has one value in the port: a CUDA tensor always takes
the fused kernel and a CPU tensor the plain version, so the device spec
implies it (``spec.device.runs_kernels`` and a compressor with a kernel).
``use_kernel_options`` pins it, as the reference's tests do.

Validity is structural:

  * ``hier`` needs a real pod split (``spec.n_outer > 1``); with a sparse
    compressor it carries the ``outer`` EF slots (``outer_ef``);
  * the flat dimension is re-padded per block size, so candidates are
    priced on the vector they would move;
  * ``n_buckets`` clamps to the alignment-unit count (the ``Bucketer``
    policy): a clamped candidate is priced at its effective count.

Optimizer-state memory is priced from the declared slot registry
(``repro_torch.state``): every candidate carries
``state_bytes_per_rank``, and a ``layouts`` axis with
``max_state_bytes_per_rank`` trades the replicated layout against zero1.
``sync_intervals`` (0/1 Adam) divides the per-step cost by the interval
under an optional per-step budget (``max_bytes_per_step`` /
``max_t_per_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.compression import padded_length
from repro_torch.plan import schedules
from repro_torch.plan.cost import (ClusterSpec, cross_pod_bytes,
                                   plan_compute_time, plan_time)
from repro_torch.plan.ir import CommPlan

TOPOLOGIES = ("flat", "hier")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One priced point of the (topology x compressor x block x buckets
    x use_kernel x sync interval x overlap) grid."""

    topology: str
    compressor: str
    block_size: int
    plan: Optional[CommPlan]
    t_exchange: float            # priced seconds a sync exchange
    hlo_bytes: float             # per-device collective bytes
    dci_bytes_per_pod: int       # bytes a pod over the cross tier
    d_padded: int
    outer_ef: bool = False       # plan carries the outer EF slots
    valid: bool = True
    why: str = ""                # reason when invalid
    n_buckets: int = 1           # effective pipeline bucket count
    sync_interval: int = 1       # steps between exchanges (0/1 Adam)
    use_kernel: bool = False     # fused CUDA compress path priced
    t_compute: float = 0.0       # compute share of t_exchange
    layout: str = "replicated"   # optimizer-state layout priced
    state_bytes_per_rank: int = 0  # from the slot registry's extents
    wire_watermark_bytes: float = 0.0  # peak concurrent staging bytes
    peak_bytes_per_rank: float = 0.0   # state + watermark + fixed bytes
    overlap_bwd: bool = False    # ready-order backward overlap priced:
    #                              t_exchange is then the seconds exposed
    #                              beyond backward
    t_bwd: float = 0.0           # backward seconds the overlap hid under
    ready_times: Tuple[float, ...] = ()  # per-bucket predicted ready s

    @property
    def t_step_avg(self) -> float:
        """Average exchange seconds a training step."""
        return self.t_exchange / max(self.sync_interval, 1)

    @property
    def bytes_per_step(self) -> float:
        """Average per-device collective bytes a training step."""
        return self.hlo_bytes / max(self.sync_interval, 1)

    def summary(self) -> Dict[str, object]:
        return {"topology": self.topology, "compressor": self.compressor,
                "block_size": self.block_size, "valid": self.valid,
                "n_buckets": self.n_buckets,
                "sync_interval": self.sync_interval,
                "use_kernel": self.use_kernel,
                "t_exchange_s": self.t_exchange,
                "t_compute_s": self.t_compute,
                "t_step_avg_s": self.t_step_avg,
                "layout": self.layout,
                "state_bytes_per_rank": self.state_bytes_per_rank,
                "wire_watermark_bytes": self.wire_watermark_bytes,
                "peak_bytes_per_rank": self.peak_bytes_per_rank,
                "hlo_bytes": self.hlo_bytes,
                "bytes_per_step": self.bytes_per_step,
                "dci_bytes_per_pod": self.dci_bytes_per_pod,
                "outer_ef": self.outer_ef,
                "overlap_bwd": self.overlap_bwd,
                "t_bwd_s": self.t_bwd,
                "why": self.why}


@dataclasses.dataclass(frozen=True)
class TuneResult:
    best: Candidate
    table: Tuple[Candidate, ...]   # every enumerated candidate, priced

    def summary(self) -> Dict[str, object]:
        return {"best": self.best.summary(),
                "table": [c.summary() for c in self.table]}


def _axes_for(spec: ClusterSpec, topology: str):
    """Axis names for offline plan construction (the cost model reads
    only group sizes)."""
    if topology == "hier":
        return ("data",), ("pod",)
    return (("pod", "data") if spec.n_outer > 1 else ("data",)), ()


def _invalid(topology, compressor, block_size, d, why,
             n_buckets=1, sync_interval=1, use_kernel=False,
             layout="replicated") -> Candidate:
    # the requested bucket count, so the table shows every grid point
    return Candidate(topology, compressor, block_size, None,
                     float("inf"), 0.0, 0, d, valid=False, why=why,
                     n_buckets=n_buckets, sync_interval=sync_interval,
                     use_kernel=use_kernel, layout=layout)


def implied_use_kernel(spec: ClusterSpec, compressor: str) -> bool:
    """The kernel axis's one value: the fused path runs where the device
    runs the port's kernels and the compressor has one."""
    from repro_torch.optim.compressors import compressor_has_kernel
    return spec.device.runs_kernels and compressor_has_kernel(compressor)


def layout_state_bytes(spec: ClusterSpec, d_pad: int, topology: str,
                       layout: str) -> int:
    """Per-rank optimizer-state bytes, read off the declared slot extents
    (``repro_torch.state``)."""
    from repro_torch.optim.base import TwoStageOptimizer
    from repro_torch.state import StateLayout, state_bytes
    n_srv = spec.n_inner if topology == "hier" else spec.n_total
    ctx = StateLayout(d=d_pad, n_dp=spec.n_total, n_srv=n_srv,
                      n_outer=spec.n_outer if topology == "hier" else 1)
    return state_bytes(TwoStageOptimizer().state_slots(layout), ctx)


def build_candidate(spec: ClusterSpec, d: int, topology: str,
                    compressor: str, block_size: int,
                    compressor_kwargs: Optional[dict] = None,
                    n_buckets: int = 1,
                    sync_interval: int = 1,
                    use_kernel: bool = False,
                    price_compute: bool = True,
                    layout: str = "replicated",
                    overlap_bwd: bool = False,
                    t_bwd: float = 0.0,
                    ready_times_fn=None) -> Candidate:
    """Price one (topology, compressor, block_size, n_buckets,
    use_kernel, overlap_bwd) point.

    ``price_compute`` folds the compressor's declared compute into the
    price: serially for ``n_buckets == 1``, through the list schedule
    otherwise.  ``use_kernel`` prices the fused CUDA path; a compressor
    without one gives an invalid candidate.

    ``overlap_bwd`` prices ready-order backward overlap through the
    four-stream breakdown: per-bucket ready times from
    ``ready_times_fn(offsets, d_pad)`` or, absent one, a linear sweep of
    ``t_bwd`` seconds over the flat vector.  The candidate's
    ``t_exchange`` is then the time exposed beyond backward, so overlap
    and after-backward candidates price the same quantity.  Needs
    ``n_buckets > 1``."""
    from repro_torch.optim.compressors import (compressor_has_kernel,
                                               get_compressor)
    kw = dict(compressor_kwargs or {})
    kw["block_size"] = block_size
    if use_kernel:
        try:
            if not compressor_has_kernel(compressor):
                return _invalid(topology, compressor, block_size, d,
                                "no fused kernel path", n_buckets,
                                sync_interval, use_kernel)
        except KeyError as e:
            return _invalid(topology, compressor, block_size, d, str(e),
                            n_buckets, sync_interval, use_kernel)
    try:
        comp = get_compressor(compressor, **kw)
    except (ValueError, TypeError, KeyError) as e:
        return _invalid(topology, compressor, block_size, d, str(e),
                        n_buckets, sync_interval, use_kernel)
    d_pad = padded_length(d, spec.n_total, block_size)
    if topology == "hier":
        if spec.n_outer <= 1:
            return _invalid(topology, compressor, block_size, d_pad,
                            "hier needs n_outer > 1", n_buckets,
                            sync_interval, use_kernel)
        inner_axes, outer_axes = _axes_for(spec, topology)
        outer_ef = schedules.needs_outer_ef(comp)
        plan = schedules.hier_schedule(comp, d_pad, spec.n_inner,
                                       spec.n_outer, inner_axes, outer_axes,
                                       outer_ef=outer_ef)
    else:
        axes, _ = _axes_for(spec, topology)
        tier = "intra" if spec.n_outer <= 1 else "cross"
        plan = schedules.flat_schedule(comp, d_pad, spec.n_total, axes,
                                       tier=tier)
        outer_ef = False
    if overlap_bwd and n_buckets <= 1:
        return _invalid(topology, compressor, block_size, d_pad,
                        "overlap-bwd needs a pipelined exchange "
                        "(n_buckets > 1)", n_buckets, sync_interval,
                        use_kernel, layout)
    ready = None
    t_bwd_eff = 0.0
    if n_buckets > 1:
        from repro_torch.pipeline import Bucketer, lower_to_pipelined
        from repro_torch.plan.cost import (bucket_staging_bytes,
                                           pipeline_breakdown,
                                           wire_watermark)
        bk = Bucketer.for_exchange(d_pad, spec.n_total, block_size,
                                   n_buckets)
        pplan = lower_to_pipelined(plan, comp, bk, use_kernel=use_kernel)
        if overlap_bwd:
            offs = tuple(bp.offset for bp in pplan.buckets)
            if ready_times_fn is not None:
                ready = [max(float(r), 0.0)
                         for r in ready_times_fn(offs, d_pad)]
            else:
                ready = [float(t_bwd) * (d_pad - o) / d_pad
                         for o in offs]
            t_bwd_eff = max(ready) if ready else 0.0
        bd = pipeline_breakdown(pplan, spec,
                                include_compute=price_compute,
                                ready=ready)
        # overlap candidates pay what the bwd stream fails to hide;
        # after-backward candidates pay the whole exchange
        t_ex = bd["t_total"] - t_bwd_eff
        t_comp = float(bd["busy"].get("compute", 0.0))
        eff_buckets = bk.n_buckets
        watermark = wire_watermark(bd["intervals"],
                                   bucket_staging_bytes(pplan))
    else:
        t_comp = (plan_compute_time(plan, comp, spec, use_kernel)
                  if price_compute else 0.0)
        t_ex = plan_time(plan, spec) + t_comp
        eff_buckets = 1
        watermark = float(sum(op.payload_bytes for op in plan.ops))
    return Candidate(topology, compressor, block_size, plan,
                     t_ex, plan.hlo_bytes(),
                     cross_pod_bytes(plan, spec), d_pad,
                     outer_ef=outer_ef, n_buckets=eff_buckets,
                     sync_interval=max(sync_interval, 1),
                     use_kernel=use_kernel, t_compute=t_comp,
                     layout=layout,
                     state_bytes_per_rank=layout_state_bytes(
                         spec, d_pad, topology, layout),
                     wire_watermark_bytes=watermark,
                     overlap_bwd=bool(overlap_bwd),
                     t_bwd=t_bwd_eff,
                     ready_times=tuple(ready) if ready else ())


def enumerate_candidates(spec: ClusterSpec, d: int,
                         compressors: Optional[Sequence[str]] = None,
                         block_sizes: Sequence[int] = (1024, 4096, 16384),
                         topologies: Sequence[str] = TOPOLOGIES,
                         compressor_kwargs: Optional[dict] = None,
                         n_buckets_options: Sequence[int] = (1,),
                         sync_intervals: Sequence[int] = (1,),
                         use_kernel_options: Optional[Sequence[bool]] = None,
                         price_compute: bool = True,
                         layouts: Sequence[str] = ("replicated",),
                         overlap_bwd_options: Sequence[bool] = (False,),
                         t_bwd: float = 0.0,
                         ready_times_fn=None
                         ) -> Tuple[Candidate, ...]:
    """Every grid point, priced.  ``use_kernel_options=None`` takes each
    compressor's implied value (:func:`implied_use_kernel`)."""
    from repro_torch.optim.compressors import list_compressors
    names = list(compressors) if compressors else list_compressors()
    out = []
    for topo in topologies:
        if topo not in TOPOLOGIES:
            raise ValueError(f"unknown topology {topo!r}; one of "
                             f"{TOPOLOGIES}")
        for name in names:
            kernel_opts = (use_kernel_options
                           if use_kernel_options is not None
                           else (implied_use_kernel(spec, name),))
            for block in block_sizes:
                for nb in n_buckets_options:
                    for uk in kernel_opts:
                        for ob in overlap_bwd_options:
                            if ob and nb <= 1:
                                continue   # nothing to ready-order
                            # the plan is priced once: the sync interval
                            # rescales the per-step figures and the
                            # layout swaps the state bytes
                            base = build_candidate(
                                spec, d, topo, name, block,
                                compressor_kwargs, n_buckets=nb,
                                use_kernel=uk,
                                price_compute=price_compute,
                                layout=layouts[0],
                                overlap_bwd=ob, t_bwd=t_bwd,
                                ready_times_fn=ready_times_fn)
                            for lay in layouts:
                                c = base if lay == layouts[0] else \
                                    dataclasses.replace(
                                        base, layout=lay,
                                        state_bytes_per_rank=(
                                            layout_state_bytes(
                                                spec, base.d_padded,
                                                topo, lay)
                                            if base.valid else 0))
                                out.extend(dataclasses.replace(
                                    c, sync_interval=max(si, 1))
                                    for si in sync_intervals)
    return tuple(out)


def _dedupe(cands: Tuple[Candidate, ...]) -> Tuple[Candidate, ...]:
    """Clamped bucket counts collapse onto one effective candidate; keep
    the first of each key."""
    seen, out = set(), []
    for c in cands:
        key = (c.topology, c.compressor, c.block_size, c.n_buckets,
               c.sync_interval, c.use_kernel, c.layout, c.overlap_bwd,
               c.valid)
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return tuple(out)


def autotune(spec: ClusterSpec, d: int,
             compressors: Optional[Sequence[str]] = None,
             block_sizes: Sequence[int] = (1024, 4096, 16384),
             topologies: Sequence[str] = TOPOLOGIES,
             compressor_kwargs: Optional[dict] = None,
             n_buckets_options: Sequence[int] = (1,),
             sync_intervals: Sequence[int] = (1,),
             use_kernel_options: Optional[Sequence[bool]] = None,
             price_compute: bool = True,
             max_bytes_per_step: Optional[float] = None,
             max_t_per_step: Optional[float] = None,
             layouts: Sequence[str] = ("replicated",),
             max_state_bytes_per_rank: Optional[int] = None,
             hbm_capacity: Optional[float] = None,
             fixed_bytes_per_rank: float = 0.0,
             overlap_bwd_options: Sequence[bool] = (False,),
             t_bwd: float = 0.0,
             ready_times_fn=None) -> TuneResult:
    """Cheapest valid plan on ``spec`` for a ``d``-element exchange.

    Selection order: smallest ``sync_interval`` first, then average
    per-step exchange time, then fewer buckets, then ``flat`` before
    ``hier``, then the larger block size, then the plain path before the
    kernel, then overlap off, then the replicated layout before zero1.
    ``max_bytes_per_step`` / ``max_t_per_step`` mark over-budget
    candidates invalid (``"over comm budget"``),
    ``max_state_bytes_per_rank`` does so against the state bytes
    (``"over state-memory budget"``), and ``hbm_capacity`` against
    ``state + watermark + fixed_bytes_per_rank`` (``"over hbm
    capacity"``).  ``price_compute=False`` prices the links only."""
    table = _dedupe(enumerate_candidates(
        spec, d, compressors, block_sizes, topologies, compressor_kwargs,
        n_buckets_options, sync_intervals, use_kernel_options,
        price_compute, layouts, overlap_bwd_options, t_bwd,
        ready_times_fn))
    if (max_bytes_per_step is not None or max_t_per_step is not None
            or max_state_bytes_per_rank is not None
            or hbm_capacity is not None):
        budgeted = []
        for c in table:
            peak = (c.state_bytes_per_rank + c.wire_watermark_bytes
                    + float(fixed_bytes_per_rank))
            over = c.valid and (
                (max_bytes_per_step is not None
                 and c.bytes_per_step > max_bytes_per_step)
                or (max_t_per_step is not None
                    and c.t_step_avg > max_t_per_step))
            over_state = c.valid and (
                max_state_bytes_per_rank is not None
                and c.state_bytes_per_rank > max_state_bytes_per_rank)
            over_hbm = c.valid and (
                hbm_capacity is not None and peak > hbm_capacity)
            budgeted.append(dataclasses.replace(
                c, peak_bytes_per_rank=peak,
                valid=(c.valid and not over and not over_state
                       and not over_hbm),
                why=c.why or ("over comm budget" if over
                              else "over state-memory budget"
                              if over_state
                              else "over hbm capacity"
                              if over_hbm else "")))
        table = tuple(budgeted)
    valid = [c for c in table if c.valid]
    if not valid:
        raise ValueError(f"no valid plan for {spec.name} (d={d}): "
                         + "; ".join(sorted({c.why for c in table})))
    from repro_torch.optim.base import LAYOUTS
    best = min(valid, key=lambda c: (c.sync_interval, c.t_step_avg,
                                     c.n_buckets,
                                     TOPOLOGIES.index(c.topology),
                                     -c.block_size, c.use_kernel,
                                     c.overlap_bwd,
                                     LAYOUTS.index(c.layout)))
    return TuneResult(best=best, table=table)
