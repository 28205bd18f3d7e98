"""The port's cluster tuner (``repro_torch.plan.tune``) against the JAX
package's (``repro.plan.tune``) on the same cluster and device numbers.

For a slow-cross cluster (10 Gbps between pods), a uniform one and a
one-pod one, over compressors, block sizes, bucket counts, backward
overlap, sync intervals and layouts, with ``use_kernel_options`` pinned
on both sides (the reference's tests pin it; the port's default is the
one value the device implies): the same ``best``, the same table in the
same order, the same valid set, each valid candidate's ``t_exchange``,
``t_compute``, ``dci_bytes_per_pod``, wire watermark and state bytes
within rel 1e-12, and the same ``why`` for the invalid ones.  Budgets
(bytes, time, state, capacity) invalidate the same candidates.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.perf.device import DeviceSpec as JDevice  # noqa: E402
from repro.plan import cost as jcost  # noqa: E402
from repro.plan import tune as jtune  # noqa: E402
from repro_torch.perf.device import DeviceSpec as TDevice  # noqa: E402
from repro_torch.plan import cost as tcost  # noqa: E402
from repro_torch.plan import tune as ttune  # noqa: E402

DEV = dict(peak_flops=4.0e14, hbm_bw=2.0e12, kernel_overhead=6e-6)
CLUSTERS = {
    "slow_cross": ((1e-6, 3.0e11), (50e-6, 1.25e9), 4, 2),
    "uniform": ((1e-6, 3.0e11), (1e-6, 3.0e11), 2, 2),
    "one_pod": ((1e-6, 3.0e11), (50e-6, 1.25e9), 8, 1),
}
D = 3 * 1000 * 1000 + 17


def _specs(name, backend="cuda"):
    intra, cross, n_inner, n_outer = CLUSTERS[name]
    j = jcost.ClusterSpec(name, jcost.LinkSpec(*intra),
                          jcost.LinkSpec(*cross), n_inner, n_outer,
                          device=JDevice("d", **DEV))
    t = tcost.ClusterSpec(name, tcost.LinkSpec(*intra),
                          tcost.LinkSpec(*cross), n_inner, n_outer,
                          device=TDevice("d", **DEV, backend=backend))
    return j, t


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def _key(c):
    return (c.topology, c.compressor, c.block_size, c.n_buckets,
            c.sync_interval, c.use_kernel, c.layout, c.overlap_bwd,
            c.valid)


def _same(jres, tres):
    assert _key(tres.best) == _key(jres.best)
    assert [_key(c) for c in tres.table] == [_key(c) for c in jres.table]
    for j, t in zip(jres.table, tres.table):
        if not j.valid:
            assert t.why == j.why, (t.why, j.why)
            continue
        for f in ("t_exchange", "t_compute", "t_bwd", "hlo_bytes",
                  "wire_watermark_bytes", "peak_bytes_per_rank"):
            assert _close(getattr(t, f), getattr(j, f)), (f, t, j)
        assert (t.dci_bytes_per_pod, t.d_padded, t.outer_ef,
                t.state_bytes_per_rank) == \
            (j.dci_bytes_per_pod, j.d_padded, j.outer_ef,
             j.state_bytes_per_rank)
        assert len(t.ready_times) == len(j.ready_times)
        for a, b in zip(t.ready_times, j.ready_times):
            assert _close(a, b)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("kernels", [(False,), (True,), (False, True)])
@pytest.mark.parametrize("price_compute", [True, False])
def test_autotune_matches_reference(cluster, kernels, price_compute):
    js, ts = _specs(cluster)
    kw = dict(block_sizes=(1024, 4096), n_buckets_options=(1, 2, 4),
              use_kernel_options=kernels, price_compute=price_compute,
              overlap_bwd_options=(False, True), t_bwd=4e-3)
    _same(jtune.autotune(js, D, **kw), ttune.autotune(ts, D, **kw))


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_autotune_axes_and_budgets_match_reference(cluster):
    js, ts = _specs(cluster)
    base = dict(compressors=["onebit", "topk"], block_sizes=(4096,),
                n_buckets_options=(1, 2), sync_intervals=(1, 2, 4),
                use_kernel_options=(False,),
                layouts=("replicated", "zero1"))
    _same(jtune.autotune(js, D, **base), ttune.autotune(ts, D, **base))
    free = jtune.autotune(js, D, **base).best
    budgets = [dict(max_bytes_per_step=free.bytes_per_step / 3),
               dict(max_t_per_step=free.t_step_avg * 0.9),
               dict(max_state_bytes_per_rank=free.state_bytes_per_rank - 1),
               dict(hbm_capacity=free.state_bytes_per_rank * 0.9,
                    fixed_bytes_per_rank=1e6)]
    for budget in budgets:
        kw = dict(base, **budget)
        try:
            want = jtune.autotune(js, D, **kw)
        except AssertionError:       # the reference's "no valid plan"
            with pytest.raises(ValueError, match="no valid plan"):
                ttune.autotune(ts, D, **kw)
            continue
        _same(want, ttune.autotune(ts, D, **kw))


def test_ready_times_fn_matches_reference():
    js, ts = _specs("slow_cross")

    def ready(offsets, d_pad):
        return [2e-3 * (1.0 - o / d_pad) ** 2 for o in offsets]

    kw = dict(compressors=["onebit"], block_sizes=(4096,),
              n_buckets_options=(2, 4, 8), use_kernel_options=(True,),
              overlap_bwd_options=(False, True), ready_times_fn=ready)
    _same(jtune.autotune(js, D, **kw), ttune.autotune(ts, D, **kw))


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("topology", ["flat", "hier"])
@pytest.mark.parametrize("layout", ["replicated", "local", "zero1"])
def test_layout_state_bytes_match_reference(cluster, topology, layout):
    js, ts = _specs(cluster)
    d_pad = 64 * 4096 * js.n_total
    assert ttune.layout_state_bytes(ts, d_pad, topology, layout) == \
        jtune.layout_state_bytes(js, d_pad, topology, layout)


def test_kernel_axis_is_the_one_the_device_implies():
    """Unpinned, the port prices each compressor on the path its tensors
    take: the fused kernel on a CUDA device spec (top-k has none), the
    plain chain on the CPU; the priced table equals the reference's
    pinned to that value."""
    for backend, onebit_kernel in (("cuda", True), ("cpu", False)):
        js, ts = _specs("slow_cross", backend)
        res = ttune.autotune(ts, D, block_sizes=(4096,),
                             n_buckets_options=(1, 2))
        by_comp = {c.compressor: c.use_kernel for c in res.table}
        assert by_comp == {"identity": False, "onebit": onebit_kernel,
                           "topk": False}
        assert ttune.implied_use_kernel(ts, "onebit") == onebit_kernel
        for comp in ("identity", "onebit", "topk"):
            kw = dict(compressors=[comp], block_sizes=(4096,),
                      n_buckets_options=(1, 2))
            want = jtune.autotune(js, D, use_kernel_options=(
                by_comp[comp],), **kw)
            _same(want, ttune.autotune(ts, D, **kw))
