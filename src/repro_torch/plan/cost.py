"""α-β cost model over CommPlans, and declarative cluster descriptions.

A :class:`ClusterSpec` describes a two-tier cluster: ``n_outer`` pods of
``n_inner`` data-parallel ranks, with an ``intra`` link (in-pod: NVLink)
and a ``cross`` link (between pods: TCP / InfiniBand).  Each link is an
α-β pair — per-message latency α seconds and per-device bandwidth β
bytes/s — the model behind the paper's Sec. 6 analysis ("communication
is the bottleneck on 10-100 Gbps Ethernet").

Consumers:

  * ``plan_time(plan, spec)`` — predicted seconds of one execution of a
    plan, each op priced by the α-β formula of its kind on its tier;
  * ``plan.hlo_bytes()`` + ``cross_pod_bytes`` — byte accounting, held
    to the bytes counted at the ``torch.distributed`` call boundary by
    ``repro_torch.benchmarks.comm_volume --check-plans``;
  * ``predict_step_time`` — plan time plus the 6ND model compute of
    ``analysis.model_math``.

Compute is a priced stream too (``repro_torch.perf``): every
``ClusterSpec`` embeds a :class:`~repro_torch.perf.device.DeviceSpec`,
``op_compute`` maps each collective op to the (pre, post) roofline
:class:`~repro_torch.perf.kernel_cost.ComputeSpec` pair of its compress
and decompress legs (from ``Compressor.compute_specs``), and
``pipeline_breakdown`` list-schedules the streams ``compute`` / ``intra``
/ ``cross`` (and ``bwd`` with ready times).

Per-op α-β formulas (n = group size, S = per-device operand bytes, O =
per-device gathered-result chunk bytes), each plus the cluster's
per-collective launch overhead ``op_overhead``:

  AllToAll              α + S·(n-1)/n / β     pairwise, concurrent
  AllGather      ⌈log2 n⌉·α + O·(n-1) / β     recursive doubling
  AllReduce     2⌈log2 n⌉·α + 2S·(n-1)/n / β  reduce-scatter + gather
  ReduceScatter  ⌈log2 n⌉·α + S·(n-1)/n / β
  Broadcast      ⌈log2 n⌉·(α + S/β)           binomial tree

Only the intra link can be measured on one machine
(``repro_torch.benchmarks.comm_sweep`` over NCCL); the cross links of the
presets are the network data sheets' figures.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from repro_torch.perf.device import (MEASURED_PREFIX, DeviceSpec, as_device,
                                     get_device)
from repro_torch.perf.kernel_cost import (ComputeSpec, ZERO_COMPUTE,
                                          combine_cost)
from repro_torch.plan.ir import (AllGather, AllReduce, AllToAll, Broadcast,
                                 CollectiveOp, CommPlan, ReduceScatter,
                                 log2ceil)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One interconnect tier: α latency (s/message), β bandwidth (bytes/s
    a device sends)."""

    latency: float
    bandwidth: float


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A two-tier cluster: ``n_outer`` pods x ``n_inner`` dp ranks."""

    name: str
    intra: LinkSpec
    cross: LinkSpec
    n_inner: int
    n_outer: int = 1
    # the chip: peak FLOP/s, HBM bandwidth, launch overhead; the compute
    # stream of the pipelined pricing is rooflined against it
    device: DeviceSpec = get_device("h100-sxm")
    # fixed cost per collective launch, independent of the tier: what
    # makes a 2-op flat schedule beat a 4-op hierarchical one on a
    # uniform fabric where both move the same bytes
    op_overhead: float = 5e-6

    @property
    def peak_flops(self) -> float:
        return self.device.peak_flops

    @property
    def hbm_bw(self) -> float:
        return self.device.hbm_bw

    @property
    def n_total(self) -> int:
        return self.n_inner * self.n_outer

    def link(self, tier: str) -> LinkSpec:
        return self.intra if tier == "intra" else self.cross

    @property
    def uniform(self) -> bool:
        return self.n_outer <= 1 or self.cross == self.intra

    @classmethod
    def from_measured(cls, path: str, n_inner: Optional[int] = None,
                      n_outer: Optional[int] = None,
                      **kw) -> "ClusterSpec":
        """Build a spec from a ``repro_torch.benchmarks.comm_sweep`` JSON:
        α/β per tier and ``op_overhead`` calibrated from timed
        collectives.  ``n_inner`` / ``n_outer`` re-size it for another
        deployment on the same interconnect; ``cross`` falls back to
        ``intra`` for a one-pod sweep.  A fit that clamped a term (a
        non-empty ``clamped`` list) is refused."""
        with open(path) as f:
            data = json.load(f)
        if data.get("clamped"):
            raise ValueError(
                f"{path}: calibration clamped {data['clamped']}: the "
                "timings did not resolve these terms; run "
                "repro_torch.benchmarks.comm_sweep again instead of "
                "loading this fit")
        intra = LinkSpec(latency=float(data["intra"]["latency"]),
                         bandwidth=float(data["intra"]["bandwidth"]))
        cross = (LinkSpec(latency=float(data["cross"]["latency"]),
                          bandwidth=float(data["cross"]["bandwidth"]))
                 if data.get("cross") else intra)
        if "op_overhead" in data:
            kw.setdefault("op_overhead", float(data["op_overhead"]))
        if "device" in kw:
            kw["device"] = as_device(kw["device"])
        return cls(name=str(data.get("name", "measured")),
                   intra=intra, cross=cross,
                   n_inner=int(n_inner if n_inner is not None
                               else data.get("n_inner", 1)),
                   n_outer=int(n_outer if n_outer is not None
                               else data.get("n_outer", 1)),
                   **kw)


# --------------------------------------------------------------------------
# cluster presets (interconnect characters; sized by the caller)
# --------------------------------------------------------------------------

def _preset(name, intra, cross):
    def build(n_inner: int, n_outer: int = 1, **kw) -> ClusterSpec:
        return ClusterSpec(name=name, intra=intra, cross=cross,
                           n_inner=n_inner, n_outer=n_outer, **kw)
    return build


# the H100's NVLink (data sheet: 900 GB/s a GPU, both directions together;
# β counts what one device sends, 450 GB/s); the latency is a guess.
# repro_torch.benchmarks.comm_sweep replaces both with the card's own
NVLINK = LinkSpec(1e-6, 450e9)

CLUSTERS: Dict[str, object] = {
    # one fast fabric everywhere (one NVLink/NVSwitch island)
    "uniform": _preset("uniform", NVLINK, NVLINK),
    # the paper's headline setting: fast in-node, 10 Gbps TCP between
    "ethernet-10g": _preset("ethernet-10g", NVLINK,
                            LinkSpec(50e-6, 1.25e9)),
    # 100 Gbps Ethernet (the paper's Fig. 8 middle case)
    "ethernet-100g": _preset("ethernet-100g", NVLINK,
                             LinkSpec(20e-6, 12.5e9)),
    # InfiniBand EDR-class cross-pod
    "infiniband": _preset("infiniband", NVLINK, LinkSpec(5e-6, 25e9)),
}


def get_cluster(name: str, n_inner: int, n_outer: int = 1,
                **kw) -> ClusterSpec:
    """Size a cluster preset; ``device=`` takes a DeviceSpec, a
    ``repro_torch.perf`` preset name or ``measured:<path>`` (default:
    h100-sxm).  ``measured:<path>`` as the cluster loads a ``comm_sweep``
    JSON instead of a preset, re-sized to this deployment's pod split."""
    if name.startswith(MEASURED_PREFIX):
        return ClusterSpec.from_measured(name[len(MEASURED_PREFIX):],
                                         n_inner=n_inner, n_outer=n_outer,
                                         **kw)
    if name not in CLUSTERS:
        raise KeyError(f"unknown cluster preset {name!r}; "
                       f"registered: {sorted(CLUSTERS)} "
                       f"(or measured:<calibration.json>)")
    if "device" in kw:
        kw["device"] = as_device(kw["device"])
    return CLUSTERS[name](n_inner=n_inner, n_outer=n_outer, **kw)


def list_clusters():
    return sorted(CLUSTERS)


# --------------------------------------------------------------------------
# α-β op and plan pricing
# --------------------------------------------------------------------------

# α-β time of each kind without the launch overhead, which op_time adds
# once for every priced op
_LINK_TIME = {
    AllToAll: lambda n, s, a, b: a + s * (n - 1) / n / b,
    AllGather: lambda n, s, a, b: log2ceil(n) * a + s * (n - 1) / b,
    AllReduce: lambda n, s, a, b: (2 * log2ceil(n) * a
                                   + 2.0 * s * (n - 1) / n / b),
    ReduceScatter: lambda n, s, a, b: (log2ceil(n) * a
                                       + s * (n - 1) / n / b),
    Broadcast: lambda n, s, a, b: log2ceil(n) * (a + s / b),
}


def op_time(op: CollectiveOp, spec: ClusterSpec) -> float:
    """Predicted seconds of one collective op on its tier's link."""
    n = op.n
    if n <= 1 or not op.axes:
        return 0.0
    if type(op) not in _LINK_TIME:
        raise TypeError(f"op_time: unknown collective {type(op).__name__}")
    link = spec.link(op.tier)
    s = float(op.payload_bytes)
    return spec.op_overhead + _LINK_TIME[type(op)](n, s, link.latency,
                                                   link.bandwidth)


# the same formulas as linear coefficients (overhead, α, 1/β): the rows
# of comm_sweep's least-squares fit.  op_time_kind prices through them, so
# a fitted spec reproduces its samples by construction
_LINK_COEFFS = {
    AllToAll: lambda n, s: (1.0, s * (n - 1) / n),
    AllGather: lambda n, s: (log2ceil(n), s * (n - 1)),
    AllReduce: lambda n, s: (2.0 * log2ceil(n), 2.0 * s * (n - 1) / n),
    ReduceScatter: lambda n, s: (log2ceil(n), s * (n - 1) / n),
    Broadcast: lambda n, s: (log2ceil(n), log2ceil(n) * s),
}
_KIND_TO_CLASS = {cls.__name__: cls for cls in _LINK_COEFFS}


def op_coeffs_kind(kind: str, n: int,
                   payload_bytes: float) -> Tuple[float, float, float]:
    """Linear coefficients ``(overhead, α, 1/β)`` of one collective's
    α-β time, keyed by kind name (``op.kind``), for callers that hold
    measured samples rather than IR ops."""
    if kind not in _KIND_TO_CLASS:
        raise KeyError(f"op_coeffs_kind: unknown collective kind {kind!r}; "
                       f"known: {sorted(_KIND_TO_CLASS)}")
    ca, cb = _LINK_COEFFS[_KIND_TO_CLASS[kind]](int(n),
                                                float(payload_bytes))
    return 1.0, ca, cb


def op_time_kind(kind: str, tier: str, n: int, payload_bytes: float,
                 spec: ClusterSpec) -> float:
    """``op_time`` for (kind, tier, n, bytes): the same formulas, through
    the coefficient rows."""
    if n <= 1:
        return 0.0
    ov, ca, cb = op_coeffs_kind(kind, n, payload_bytes)
    link = spec.link(tier)
    return (ov * spec.op_overhead + ca * link.latency
            + cb / link.bandwidth)


def plan_time(plan: CommPlan, spec: ClusterSpec) -> float:
    """Predicted seconds of one execution of the plan (no overlap)."""
    return sum(op_time(op, spec) for op in plan.ops)


# --------------------------------------------------------------------------
# compute pricing (the op's compress and decompress legs)
# --------------------------------------------------------------------------

def op_compute(op: CollectiveOp, comp, use_kernel: bool = False
               ) -> Tuple[ComputeSpec, ComputeSpec]:
    """(pre, post) ComputeSpecs of one collective op: the compress (EF or
    plain) that must finish before its wire leg starts, and the
    decompress and combine that consume what it received.

    Mirrors ``repro_torch.plan.executor`` rule for rule; the costs come
    from ``comp.compute_specs(d, use_kernel)``.  Raw f32 ops (AllReduce,
    ReduceScatter, Broadcast) carry no compressor compute; ``comp=None``
    prices everything at zero."""
    if comp is None or isinstance(op, (AllReduce, ReduceScatter,
                                       Broadcast)):
        return ZERO_COMPUTE, ZERO_COMPUTE
    specs = comp.compute_specs(op.d_in, use_kernel)
    pre = specs["ef_compress" if op.err_slot is not None else "compress"]
    if isinstance(op, AllToAll):
        # decompress the n received chunks (d_in elements in all), then
        # combine them into the (d_out,) result
        post = specs["decompress"]
        if op.n > 1:
            post = post + combine_cost(op.d_in, op.n)
    elif isinstance(op, AllGather):
        post = comp.compute_specs(op.d_out, use_kernel)["decompress"]
    else:
        raise TypeError(f"op_compute: unknown collective {op.kind}")
    return pre, post


def plan_compute(plan: CommPlan, comp, use_kernel: bool = False
                 ) -> ComputeSpec:
    """Total declared compute of one serial plan execution."""
    total = ZERO_COMPUTE
    for op in plan.ops:
        pre, post = op_compute(op, comp, use_kernel)
        total = total + pre + post
    return total


def plan_compute_time(plan: CommPlan, comp, spec: ClusterSpec,
                      use_kernel: bool = False) -> float:
    """Roofline seconds of the plan's compute on ``spec.device``: what a
    serial execution adds to ``plan_time``."""
    return plan_compute(plan, comp, use_kernel).time(spec.device)


# --------------------------------------------------------------------------
# pipelined pricing (a repro_torch.pipeline.PipelinedPlan: .n_buckets,
# .n_stages, per-bucket .plan.ops and optional per-bucket .compute)
# --------------------------------------------------------------------------

def pipeline_breakdown(pplan, spec: ClusterSpec,
                       include_compute: bool = True,
                       ready=None) -> Dict[str, object]:
    """Price a pipelined plan by list-scheduling its dependency grid.

    Each link tier is one stream, and — when the lowering attached
    per-bucket (pre, post) ComputeSpecs — the device's compute engine is
    a third stream, ``"compute"``: ops on a stream run in issue order,
    ops on different streams overlap.  Per grid point ``(b, s)`` the
    chain is pre-compute -> wire -> post-compute, issued in a
    fine-grained wavefront over ``(bucket, 3*s + phase)`` so that bucket
    b+1's compress can fill the compute stream while bucket b's wire leg
    is in flight.

    Returns ``t_total`` (seconds), ``t_serial`` (the same stages back to
    back), ``saved``, per-stream ``busy`` seconds, the ``bottleneck``
    stream, its ``fill_drain`` slack, and ``intervals``, one record per
    scheduled unit of nonzero duration::

        {"bucket", "stage", "phase" ("pre"|"wire"|"post"|"bwd"), "stream",
         "kind", "tier", "t_start", "t_end"}

    ``ready`` (per-bucket seconds) adds a fourth stream, ``"bwd"``, the
    backward pass producing the gradient: busy from 0 to ``max(ready)``,
    bucket b's production interval ending at ``ready[b]``, and bucket
    b's first unit gated on ``ready[b]``; buckets then issue in
    ascending-ready order.
    """
    free: Dict[str, float] = {}
    busy: Dict[str, float] = {}
    intervals: list = []
    dev = spec.device

    def on_stream(stream: str, dep: float, t: float) -> float:
        if t <= 0.0:
            return dep          # zero-cost stage: a pass-through
        start = max(free.get(stream, 0.0), dep)
        free[stream] = start + t
        busy[stream] = busy.get(stream, 0.0) + t
        return start + t

    n_b, n_units = pplan.n_buckets, 3 * pplan.n_stages
    finish = [[0.0] * n_units for _ in range(n_b)]
    t_total = t_serial = 0.0
    if ready is not None:
        ready = [max(float(r), 0.0) for r in ready]
        if len(ready) != n_b:
            raise ValueError(
                f"ready has {len(ready)} entries for {n_b} buckets")
        # the bwd stream: one production interval a bucket, back to back
        # in ascending-ready order
        order = sorted(range(n_b), key=lambda i: (ready[i], i))
        t_prev = 0.0
        for b in order:
            t = ready[b] - t_prev
            if t > 0.0:
                busy["bwd"] = busy.get("bwd", 0.0) + t
                free["bwd"] = ready[b]
                intervals.append({
                    "bucket": b, "stage": -1, "phase": "bwd",
                    "stream": "bwd", "kind": "Bwd", "tier": "bwd",
                    "t_start": t_prev, "t_end": ready[b]})
                t_serial += t
                t_total = max(t_total, ready[b])
            t_prev = max(t_prev, ready[b])
    else:
        order = list(range(n_b))
    for tick in range(n_b + n_units - 1):
        for sigma in range(n_units):
            pos = tick - sigma
            if not 0 <= pos < n_b:
                continue
            b = order[pos]
            s, phase = divmod(sigma, 3)
            bp = pplan.buckets[b]
            op = bp.plan.ops[s]
            pre = post = None
            if include_compute and bp.compute:
                pre, post = bp.compute[s]
            dep = (finish[b][sigma - 1] if sigma > 0
                   else (ready[b] if ready is not None else 0.0))
            if phase == 0:
                t = pre.time(dev) if pre is not None else 0.0
                stream = "compute"
            elif phase == 1:
                t = op_time(op, spec)
                stream = op.tier
            else:
                t = post.time(dev) if post is not None else 0.0
                stream = "compute"
            end = on_stream(stream, dep, t)
            if t > 0.0:
                intervals.append({
                    "bucket": b, "stage": s,
                    "phase": ("pre", "wire", "post")[phase],
                    "stream": stream, "kind": op.kind, "tier": op.tier,
                    "t_start": end - t, "t_end": end})
            finish[b][sigma] = end
            t_serial += t
            t_total = max(t_total, end)
    bottleneck = max(busy, key=busy.get) if busy else "intra"
    return {"t_total": t_total, "t_serial": t_serial,
            "saved": t_serial - t_total, "busy": busy,
            "bottleneck": bottleneck,
            "fill_drain": t_total - busy.get(bottleneck, 0.0),
            "intervals": intervals}


def bucket_staging_bytes(pplan) -> list:
    """Per-bucket staging bytes: the sum of each bucket op's per-device
    operand payload (conservative: consecutive stages' buffers coexist
    across the stage handoff)."""
    return [float(sum(op.payload_bytes for op in bp.plan.ops))
            for bp in pplan.buckets]


def wire_watermark(intervals, bucket_bytes) -> float:
    """Peak concurrent staging bytes over a scheduled timeline.

    Bucket b is in flight from its first interval's ``t_start`` to its
    last interval's ``t_end`` and holds ``bucket_bytes[b]`` for that
    window; the watermark is the largest sum over buckets in flight at
    once.  ``"bwd"`` intervals are not staging (a bucket holds no wire
    buffer while its gradient is produced) and are skipped."""
    spans = {}
    for rec in intervals:
        if rec.get("phase") == "bwd":
            continue
        b = rec["bucket"]
        lo, hi = spans.get(b, (rec["t_start"], rec["t_end"]))
        spans[b] = (min(lo, rec["t_start"]), max(hi, rec["t_end"]))
    if not spans:
        return float(sum(bucket_bytes))
    events = []
    for b, (lo, hi) in spans.items():
        nbytes = float(bucket_bytes[b]) if b < len(bucket_bytes) else 0.0
        # close before open at equal times: back-to-back buckets on one
        # stream do not stack
        events.append((lo, 1, nbytes))
        events.append((hi, 0, -nbytes))
    peak = cur = 0.0
    for _, _, delta in sorted(events):
        cur += delta
        peak = max(peak, cur)
    return peak


def pipelined_plan_time(pplan, spec: ClusterSpec,
                        include_compute: bool = True) -> float:
    """Predicted seconds of one pipelined execution (overlap priced)."""
    return pipeline_breakdown(pplan, spec, include_compute)["t_total"]


def cross_pod_bytes(plan: CommPlan, spec: ClusterSpec) -> int:
    """Per-pod bytes over the cross-pod link for one plan execution.

    Hierarchical cross ops run one group per inner rank (n == n_outer):
    every wire byte crosses, on all ``n_inner`` groups at once.  A flat
    op over every rank (n == n_total) puts ``(n_outer-1)/n_outer`` of
    each rank's traffic on the cross link."""
    if spec.n_outer <= 1:
        return 0
    total = 0.0
    for op in plan.ops:
        if op.tier != "cross":
            continue
        frac = 1.0 if op.n <= spec.n_outer else \
            (spec.n_outer - 1) / spec.n_outer
        total += spec.n_inner * op.wire_send_bytes * frac
    return int(total)


# --------------------------------------------------------------------------
# composing with the analytic compute model
# --------------------------------------------------------------------------

def predict_step_time(plan: CommPlan, spec: ClusterSpec, cfg=None,
                      shape=None, tp: int = 1,
                      exchanges_per_step: int = 1,
                      comp=None, use_kernel: bool = False
                      ) -> Dict[str, float]:
    """Absolute step-time prediction: the α-β time of the optimizer
    exchange + the 6ND model compute of ``analysis.model_math`` at peak.

    ``comp`` also charges the exchange's own compress/EF compute
    (``t_exchange_compute``, rooflined on ``spec.device``; the fused path
    with ``use_kernel``).  Returns ``t_comm``, ``t_exchange_compute``,
    ``t_compute``, ``t_step`` (seconds) and, given ``cfg`` and ``shape``,
    ``flops_total`` and ``tokens_per_s`` across the cluster.  The model
    has no term for the launches of forward and backward."""
    t_comm = exchanges_per_step * plan_time(plan, spec)
    t_xc = exchanges_per_step * plan_compute_time(
        plan, comp, spec, use_kernel) if comp is not None else 0.0
    out: Dict[str, float] = {"t_comm": t_comm, "t_compute": 0.0,
                             "t_exchange_compute": t_xc}
    if cfg is not None and shape is not None:
        from repro_torch.analysis.model_math import model_flops
        fl = model_flops(cfg, shape, tp)
        total = fl["model_flops"] + fl["attn_flops"]
        devices = spec.n_total * tp
        out["t_compute"] = total / (devices * spec.peak_flops)
        out["flops_total"] = total
    out["t_step"] = out["t_compute"] + t_comm + t_xc
    if cfg is not None and shape is not None and out["t_step"] > 0:
        tokens = shape.global_batch * shape.seq_len
        out["tokens_per_s"] = tokens / out["t_step"]
    return out
