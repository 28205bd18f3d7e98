"""The port's α-β / roofline cost model (``repro_torch.plan.cost``) against
the JAX package's (``repro.plan.cost``), each side's ``DeviceSpec`` and
``ClusterSpec`` built from the same explicit numbers (the reference's
defaults are TPU presets, the port's the H100).

  * Closed forms, equal as Python floats: ``op_time`` of every collective
    kind (``ReduceScatter`` and ``Broadcast`` included) and
    ``op_coeffs_kind`` / ``op_time_kind``; ``plan_time``,
    ``cross_pod_bytes``, ``op_compute``, ``plan_compute`` and
    ``plan_compute_time`` of the flat, hierarchical and all-reduce plans
    for every compressor, n in {2, 4, 8}, 1-2 pods, the fused and the
    unfused compute; ``predict_step_time`` without a model.
  * Pricing: ``pipeline_breakdown`` with and without compute and with
    backward ``ready`` times (``t_total``, ``t_serial``, ``busy``,
    ``bottleneck``, ``fill_drain``, ``intervals``), ``bucket_staging_bytes``
    and ``wire_watermark`` on the same lowered plans: equal, or within rel
    1e-12 where a sum's order could differ.
  * Presets and calibration: the cross links of the presets are the
    reference's; ``from_measured`` loads what the reference loads and
    refuses a clamped fit; ``comm_sweep.fit_cluster`` recovers known
    (ov, α, β) from exact synthetic samples (rel 1e-6: the joint system's
    conditioning) and names what it cannot resolve.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.optim import get_compressor as jget_compressor  # noqa: E402
from repro.perf.device import DeviceSpec as JDevice  # noqa: E402
from repro.pipeline import Bucketer as JBucketer  # noqa: E402
from repro.pipeline import lower_to_pipelined as jlower  # noqa: E402
from repro.plan import cost as jcost  # noqa: E402
from repro.plan import ir as jir  # noqa: E402
from repro.plan import schedules as jsched  # noqa: E402
from repro_torch.benchmarks.comm_sweep import fit_cluster  # noqa: E402
from repro_torch.optim import get_compressor  # noqa: E402
from repro_torch.perf.device import DeviceSpec as TDevice  # noqa: E402
from repro_torch.pipeline import Bucketer  # noqa: E402
from repro_torch.pipeline import lower_to_pipelined  # noqa: E402
from repro_torch.plan import cost as tcost  # noqa: E402
from repro_torch.plan import ir as tir  # noqa: E402
from repro_torch.plan import schedules as tsched  # noqa: E402

DEV = dict(peak_flops=4.0e14, hbm_bw=2.0e12, kernel_overhead=6e-6)
INTRA, CROSS = (2e-6, 3.0e11), (50e-6, 1.25e9)
BLOCK = 256
COMPRESSORS = ("onebit", "identity", "topk")
MESHES = [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)]   # (n_inner, n_outer)


def _specs(n_inner, n_outer, op_overhead=4e-6):
    j = jcost.ClusterSpec("c", jcost.LinkSpec(*INTRA),
                          jcost.LinkSpec(*CROSS), n_inner, n_outer,
                          device=JDevice("d", **DEV), op_overhead=op_overhead)
    t = tcost.ClusterSpec("c", tcost.LinkSpec(*INTRA),
                          tcost.LinkSpec(*CROSS), n_inner, n_outer,
                          device=TDevice("d", **DEV), op_overhead=op_overhead)
    return j, t


def _comps(name, use_kernel):
    kw = {"use_kernel": True} if use_kernel and name == "onebit" else {}
    return (jget_compressor(name, block_size=BLOCK, **kw),
            get_compressor(name, block_size=BLOCK))


def _plans(name, n_inner, n_outer, use_kernel=False):
    """(reference plan, port plan) pairs: flat, hier (two pods) and the
    warmup all-reduce over every rank."""
    jc, tc = _comps(name, use_kernel)
    n = n_inner * n_outer
    d = n * BLOCK * 24
    tier = "cross" if n_outer > 1 else "intra"
    axes = ("pod", "data") if n_outer > 1 else ("data",)
    out = [(jsched.flat_schedule(jc, d, n, axes, tier=tier),
            tsched.flat_schedule(tc, d, n, axes, tier=tier)),
           (jsched.allreduce_schedule(d, n, axes, tier=tier),
            tsched.allreduce_schedule(d, n, axes, tier=tier))]
    if n_outer > 1:
        ef = jsched.needs_outer_ef(jc)
        out.append((jsched.hier_schedule(jc, d, n_inner, n_outer, ("data",),
                                         ("pod",), outer_ef=ef),
                    tsched.hier_schedule(tc, d, n_inner, n_outer, ("data",),
                                         ("pod",), outer_ef=ef)))
    return out


def _cs(x):
    return (x.flops, x.hbm_bytes, x.kernels)


@pytest.mark.parametrize("n_inner,n_outer", MESHES)
@pytest.mark.parametrize("name", COMPRESSORS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_plan_pricing_matches_reference(n_inner, n_outer, name, use_kernel):
    js, ts = _specs(n_inner, n_outer)
    jc, tc = _comps(name, use_kernel)
    for jp, tp in _plans(name, n_inner, n_outer, use_kernel):
        assert jp.name == tp.name
        for jo, to in zip(jp.ops, tp.ops):
            assert tcost.op_time(to, ts) == jcost.op_time(jo, js), to
            assert tcost.op_time_kind(to.kind, to.tier, to.n,
                                      to.payload_bytes, ts) == \
                jcost.op_time_kind(jo.kind, jo.tier, jo.n, jo.payload_bytes,
                                   js)
            for a, b in zip(tcost.op_compute(to, tc, use_kernel),
                            jcost.op_compute(jo, jc)):
                assert _cs(a) == _cs(b), (to, a, b)
        assert tcost.plan_time(tp, ts) == jcost.plan_time(jp, js)
        assert tcost.cross_pod_bytes(tp, ts) == jcost.cross_pod_bytes(jp, js)
        assert _cs(tcost.plan_compute(tp, tc, use_kernel)) == \
            _cs(jcost.plan_compute(jp, jc))
        assert tcost.plan_compute_time(tp, tc, ts, use_kernel) == \
            jcost.plan_compute_time(jp, jc, js)
        assert tp.hlo_bytes() == jp.hlo_bytes()
        for comp_pair in ((None, None), (jc, tc)):
            want = jcost.predict_step_time(jp, js, comp=comp_pair[0])
            got = tcost.predict_step_time(tp, ts, comp=comp_pair[1],
                                          use_kernel=use_kernel)
            assert got == want


@pytest.mark.parametrize("kind", ["AllToAll", "AllGather", "AllReduce",
                                  "ReduceScatter", "Broadcast"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tier", ["intra", "cross"])
def test_every_kind_prices_as_the_reference(kind, n, tier):
    js, ts = _specs(4, 2)
    d = 24 * 1024          # splits over every n
    payload = (tir.WireSpec("float32", (d,)),)
    jpayload = (jir.WireSpec("float32", (d,)),)
    to = getattr(tir, kind)(axes=("data",), n=n, tier=tier, payload=payload,
                            d_in=d)
    jo = getattr(jir, kind)(axes=("data",), n=n, tier=tier,
                            payload=jpayload, d_in=d)
    to.validate()
    assert (to.d_out, to.wire_send_bytes, to.hlo_bytes) == \
        (jo.d_out, jo.wire_send_bytes, jo.hlo_bytes)
    assert tcost.op_time(to, ts) == jcost.op_time(jo, js)
    assert tcost.op_coeffs_kind(kind, n, 4.0 * d) == \
        jcost.op_coeffs_kind(kind, n, 4.0 * d)
    assert tcost.op_time_kind(kind, tier, n, 4.0 * d, ts) == \
        jcost.op_time_kind(kind, tier, n, 4.0 * d, js)
    assert tir.log2ceil(n) == jir.log2ceil(n)
    for a, b in zip(tcost.op_compute(to, None), jcost.op_compute(jo, None)):
        assert _cs(a) == _cs(b)


def _lowered(name, n_inner, n_outer, topo, nb, use_kernel):
    jc, tc = _comps(name, use_kernel)
    n = n_inner * n_outer
    d = n * BLOCK * 24
    if topo == "hier":
        ef = jsched.needs_outer_ef(jc)
        jp = jsched.hier_schedule(jc, d, n_inner, n_outer, ("data",),
                                  ("pod",), outer_ef=ef)
        tp = tsched.hier_schedule(tc, d, n_inner, n_outer, ("data",),
                                  ("pod",), outer_ef=ef)
    else:
        tier = "cross" if n_outer > 1 else "intra"
        jp = jsched.flat_schedule(jc, d, n, ("data",), tier=tier)
        tp = tsched.flat_schedule(tc, d, n, ("data",), tier=tier)
    return (jlower(jp, jc, JBucketer.for_exchange(d, n, BLOCK, nb)),
            lower_to_pipelined(tp, tc, Bucketer.for_exchange(d, n, BLOCK,
                                                             nb),
                               use_kernel=use_kernel))


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("topo,n_inner,n_outer", [
    ("flat", 4, 1), ("flat", 2, 2), ("hier", 2, 2), ("hier", 4, 2)])
@pytest.mark.parametrize("name", COMPRESSORS)
@pytest.mark.parametrize("nb", [2, 3])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_pipeline_breakdown_matches_reference(topo, n_inner, n_outer, name,
                                              nb, use_kernel):
    js, ts = _specs(n_inner, n_outer)
    jpp, tpp = _lowered(name, n_inner, n_outer, topo, nb, use_kernel)
    for jb, tb in zip(jpp.buckets, tpp.buckets):
        for (jpre, jpost), (tpre, tpost) in zip(jb.compute, tb.compute):
            assert (_cs(tpre), _cs(tpost)) == (_cs(jpre), _cs(jpost))
    d = tpp.d
    ready = [3e-3 * (d - bp.offset) / d for bp in tpp.buckets]
    for include_compute in (False, True):
        for rd in (None, ready):
            want = jcost.pipeline_breakdown(jpp, js, include_compute, rd)
            got = tcost.pipeline_breakdown(tpp, ts, include_compute, rd)
            for k in ("t_total", "t_serial", "saved", "fill_drain"):
                assert _close(got[k], want[k]), (k, got[k], want[k])
            assert got["bottleneck"] == want["bottleneck"]
            assert sorted(got["busy"]) == sorted(want["busy"])
            for k in want["busy"]:
                assert _close(got["busy"][k], want["busy"][k])
            assert len(got["intervals"]) == len(want["intervals"])
            for a, b in zip(got["intervals"], want["intervals"]):
                assert {k: v for k, v in a.items() if not k.startswith("t_")}\
                    == {k: v for k, v in b.items() if not k.startswith("t_")}
                assert _close(a["t_start"], b["t_start"])
                assert _close(a["t_end"], b["t_end"])
            staging = tcost.bucket_staging_bytes(tpp)
            assert staging == jcost.bucket_staging_bytes(jpp)
            assert tcost.wire_watermark(got["intervals"], staging) == \
                jcost.wire_watermark(want["intervals"], staging)
        assert _close(tcost.pipelined_plan_time(tpp, ts, include_compute),
                      jcost.pipelined_plan_time(jpp, js, include_compute))


def test_presets():
    for name in ("ethernet-10g", "ethernet-100g", "infiniband"):
        t = tcost.get_cluster(name, 4, 2)
        j = jcost.get_cluster(name, 4, 2)
        assert (t.cross.latency, t.cross.bandwidth) == \
            (j.cross.latency, j.cross.bandwidth)
        assert t.intra == tcost.NVLINK and t.device.name == "h100-sxm"
    assert tcost.NVLINK.bandwidth == 450e9
    u = tcost.get_cluster("uniform", 8, device="cpu-host")
    assert u.uniform and u.device.name == "cpu-host"
    assert tcost.list_clusters() == ["ethernet-100g", "ethernet-10g",
                                     "infiniband", "uniform"]
    with pytest.raises(KeyError):
        tcost.get_cluster("tpu-dci", 4)


def test_from_measured_matches_reference(tmp_path):
    path = tmp_path / "links.json"
    with open(path, "w") as f:
        json.dump({"name": "m", "intra": {"latency": 3e-6,
                                          "bandwidth": 2.5e11},
                   "cross": None, "op_overhead": 7e-6, "n_inner": 4,
                   "n_outer": 1, "clamped": []}, f)
    j = jcost.ClusterSpec.from_measured(str(path), n_inner=2, n_outer=2,
                                        device=JDevice("d", **DEV))
    t = tcost.get_cluster("measured:" + str(path), 2, 2,
                          device=TDevice("d", **DEV))
    assert (t.name, t.intra.latency, t.intra.bandwidth, t.cross.latency,
            t.cross.bandwidth, t.op_overhead, t.n_inner, t.n_outer) == \
        (j.name, j.intra.latency, j.intra.bandwidth, j.cross.latency,
         j.cross.bandwidth, j.op_overhead, j.n_inner, j.n_outer)


def test_from_measured_refuses_a_clamped_fit(tmp_path):
    path = tmp_path / "links.json"
    with open(path, "w") as f:
        json.dump({"intra": {"latency": 1e-9, "bandwidth": 1e11},
                   "op_overhead": 5e-6, "clamped": ["intra.latency"]}, f)
    with pytest.raises(ValueError, match="clamped"):
        tcost.ClusterSpec.from_measured(str(path))


def _link_samples(ov, links):
    out = []
    for tier, (alpha, beta, n) in links.items():
        for nbytes in (4096, 1 << 16, 1 << 20, 1 << 24):
            for kind in ("AllReduce", "ReduceScatter"):
                c0, ca, cb = tcost.op_coeffs_kind(kind, n, nbytes)
                out.append({"tier": tier, "op": kind, "n": n,
                            "nbytes": nbytes,
                            "seconds": c0 * ov + ca * alpha + cb / beta})
    return out


@pytest.mark.parametrize("links", [
    {"intra": (3e-6, 2.0e11, 4)},
    {"intra": (2e-6, 3.0e11, 2), "cross": (4e-5, 1.25e9, 2)}])
def test_fit_cluster_recovers_known_coefficients(links):
    # exact samples; the system's conditioning leaves ~1e-9 of rounding
    fit = fit_cluster(_link_samples(6e-6, links))
    assert fit["clamped"] == []
    assert fit["op_overhead"] == pytest.approx(6e-6, rel=1e-6)
    for tier, (alpha, beta, _) in links.items():
        assert fit["tiers"][tier]["latency"] == pytest.approx(alpha,
                                                              rel=1e-6)
        assert fit["tiers"][tier]["bandwidth"] == pytest.approx(beta,
                                                                rel=1e-6)


def test_fit_cluster_names_what_it_cannot_resolve():
    # a latency that shortens the collective: the fitted α is negative
    samples = _link_samples(2e-5, {"intra": (-1e-6, 2e11, 4)})
    fit = fit_cluster(samples)
    assert fit["clamped"] == ["intra.latency"]
    with pytest.raises(ValueError):
        fit_cluster([dict(samples[0], n=1)])
