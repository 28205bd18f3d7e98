"""The port's analytic model (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``) on the four architectures the port has,
at full size and at smoke size.

  * ``model_math``: parameter counts and bytes (exact), activation bytes,
    per-layer backward FLOPs, ``model_flops`` for train / prefill /
    decode shapes, ``bwd_ready_times`` at bucket offsets and
    ``bwd_total_time`` on the same device numbers: equal, or within rel
    1e-12 where a sum's order differs.
  * ``predict_step_time`` with a model (the 6ND compute at peak beside
    the exchange), ``predict_point``, ``predicted_scaling`` and
    ``comm_fraction`` on the same cluster numbers, the kernel axis pinned
    as the reference enumerates it: within rel 1e-12.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import model_math as jmm  # noqa: E402
from repro.analysis import scaling as jsc  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.optim import get_compressor as jget_compressor  # noqa: E402
from repro.perf.device import DeviceSpec as JDevice  # noqa: E402
from repro.plan import cost as jcost  # noqa: E402
from repro.plan import schedules as jsched  # noqa: E402
from repro_torch.analysis import model_math as tmm  # noqa: E402
from repro_torch.analysis import scaling as tsc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape as TShape  # noqa: E402
from repro_torch.optim import get_compressor  # noqa: E402
from repro_torch.perf.device import DeviceSpec as TDevice  # noqa: E402
from repro_torch.plan import cost as tcost  # noqa: E402
from repro_torch.plan import schedules as tsched  # noqa: E402

ARCHS = [a + s for a in ("bert-large", "bert-base", "llama3.2-3b",
                         "internlm2-1.8b") for s in ("", "-smoke")]
DEV = dict(peak_flops=7.5e14, hbm_bw=2.8e12, kernel_overhead=7e-6)
SHAPES = [("train", 128, 16), ("train", 512, 4), ("prefill", 2048, 8),
          ("decode", 4096, 8)]


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_math_matches_reference(arch):
    j, t = jget_config(arch), get_config(arch)
    assert tmm.param_count_local(t) == jmm.param_count_local(j)
    assert tmm.param_bytes(t) == jmm.param_bytes(j)
    assert tmm.active_params_no_embed(t) == jmm.active_params_no_embed(j)
    assert t.padded_heads(1) == j.padded_heads(1)
    assert [t.is_attn_layer(i) for i in range(t.n_layers)] == \
        [j.is_attn_layer(i) for i in range(j.n_layers)]
    for batch, seq in ((4, 64), (16, 128)):
        assert tmm.activation_bytes(t, batch, seq) == \
            jmm.activation_bytes(j, batch, seq)
    for kind, seq, batch in SHAPES:
        js, ts = JShape("s", seq, batch, kind), TShape("s", seq, batch, kind)
        assert tmm.model_flops(t, ts) == jmm.model_flops(j, js)
        if kind == "train":
            assert tmm.layer_bwd_flops(t, ts) == jmm.layer_bwd_flops(j, js)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_buckets", [1, 3, 8])
def test_bwd_ready_times_match_reference(arch, n_buckets):
    j, t = jget_config(arch), get_config(arch)
    js, ts = JShape("s", 128, 16, "train"), TShape("s", 128, 16, "train")
    jd, td = JDevice("d", **DEV), TDevice("d", **DEV)
    d = tsc.flat_param_dim(t, n_dp=4, block=4096)
    assert d == jsc.flat_param_dim(j, n_dp=4, block=4096)
    offsets = [d * i // n_buckets for i in range(n_buckets)] + [d]
    got = tmm.bwd_ready_times(offsets, d, t, ts, td)
    want = jmm.bwd_ready_times(offsets, d, j, js, jd)
    assert all(_close(a, b) for a, b in zip(got, want)), (got, want)
    assert got[-1] == pytest.approx(0.0, abs=1e-15)   # the vector's end
    assert _close(tmm.bwd_total_time(t, ts, td), jmm.bwd_total_time(j, js, jd))
    assert _close(got[0], tmm.bwd_total_time(t, ts, td))


def _cluster(n_inner, n_outer):
    j = jcost.ClusterSpec("c", jcost.LinkSpec(1e-6, 3e11),
                          jcost.LinkSpec(5e-5, 1.25e9), n_inner, n_outer,
                          device=JDevice("d", **DEV))
    t = tcost.ClusterSpec("c", tcost.LinkSpec(1e-6, 3e11),
                          tcost.LinkSpec(5e-5, 1.25e9), n_inner, n_outer,
                          device=TDevice("d", **DEV))
    return j, t


@pytest.mark.parametrize("arch", ["bert-large", "bert-base-smoke",
                                  "llama3.2-3b"])
@pytest.mark.parametrize("n_inner,n_outer", [(1, 1), (4, 1), (4, 2)])
def test_predict_step_time_matches_reference(arch, n_inner, n_outer):
    j, t = jget_config(arch), get_config(arch)
    jsp, tsp = _cluster(n_inner, n_outer)
    n = n_inner * n_outer
    d = tsc.flat_param_dim(t, n_dp=n, block=4096)
    axes = ("pod", "data") if n_outer > 1 else ("data",)
    js, ts = JShape("s", 128, 16 * n, "train"), TShape("s", 128, 16 * n,
                                                        "train")
    for use_kernel in (False, True):
        jc = jget_compressor("onebit", block_size=4096,
                             **({"use_kernel": True} if use_kernel else {}))
        tc = get_compressor("onebit", block_size=4096)
        jp = jsched.flat_schedule(jc, d, n, axes)
        tp = tsched.flat_schedule(tc, d, n, axes)
        for comp in ((None, None), (jc, tc)):
            want = jcost.predict_step_time(jp, jsp, j, js, comp=comp[0])
            got = tcost.predict_step_time(tp, tsp, t, ts, comp=comp[1],
                                          use_kernel=use_kernel)
            assert sorted(got) == sorted(want)
            for k in want:
                assert _close(got[k], want[k]), (k, got[k], want[k])
    assert _close(tsc.comm_fraction(tp, tsp, t, ts),
                  jsc.comm_fraction(jp, jsp, j, js))


@pytest.mark.parametrize("arch", ["bert-large", "bert-base-smoke"])
@pytest.mark.parametrize("n_inner,n_outer", [(4, 1), (4, 2), (8, 4)])
def test_predict_point_matches_reference(arch, n_inner, n_outer):
    j, t = jget_config(arch), get_config(arch)
    jsp, tsp = _cluster(n_inner, n_outer)
    want = jsc.predict_point(j, 128, 16, jsp)
    got = tsc.predict_point(t, 128, 16, tsp,
                            use_kernel_options=(False, True))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert _close(got[k], v), (k, got[k], v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("cluster", ["ethernet-10g", "infiniband"])
def test_predicted_scaling_matches_reference(cluster, monkeypatch):
    """Weak scaling over pod counts on a preset's cross link; both sides
    on the same device numbers and intra link (the presets' intra links
    differ: the port's is the H100's NVLink)."""
    j, t = jget_config("bert-large"), get_config("bert-large")
    jd, td = JDevice("d", **DEV), TDevice("d", **DEV)
    intra = (1e-6, 3e11)
    cross = jcost.CLUSTERS[cluster](1).cross
    monkeypatch.setitem(
        jcost.CLUSTERS, "_test", lambda n_inner, n_outer=1, **kw:
        jcost.ClusterSpec("_test", jcost.LinkSpec(*intra), cross, n_inner,
                          n_outer, **kw))
    monkeypatch.setitem(
        tcost.CLUSTERS, "_test", lambda n_inner, n_outer=1, **kw:
        tcost.ClusterSpec("_test", tcost.LinkSpec(*intra),
                          tcost.LinkSpec(cross.latency, cross.bandwidth),
                          n_inner, n_outer, **kw))
    want = jsc.predicted_scaling(j, 128, 16, "_test", 4,
                                 pod_counts=(1, 2, 4), device=jd)
    got = tsc.predicted_scaling(t, 128, 16, "_test", 4,
                                pod_counts=(1, 2, 4), device=td,
                                use_kernel_options=(False, True))
    assert sorted(got) == sorted(want)
    for n in want:
        for k, v in want[n].items():
            if isinstance(v, float):
                assert _close(got[n][k], v), (n, k, got[n][k], v)
            else:
                assert got[n][k] == v, (n, k)
    assert want[4]["speedup"] > want[1]["speedup"]
