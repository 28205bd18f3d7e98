"""The port's per-segment fidelity audit (``repro_torch.obs.audit`` and
``TwoStageOptimizer.audit_stats``) against the JAX package's on the same
numpy inputs.

  * ``segment_l1`` / ``segment_cosine`` / ``segment_sign_agreement`` and
    every stat of ``audit_stats`` (the shadow EMA, per-segment drift, the
    fidelity of the compressed momentum, the EF-residual masses, the
    scalars) for the same ``g``, ``m``, ``v``, ``worker_err``,
    ``server_err`` and shadow ``v``: within ``tests/test_kernels.py``'s
    f32 tolerances (rtol 1e-5, atol 1e-6; the segment sums reduce in
    another order).  ``sign_agree`` is a count over coordinates: it may
    differ only where ``m_local + worker_err`` lies next to 0, and the
    test states that count (at most 2 coordinates a case; 0 was read).
  * The identity compressor is exactly faithful (cosine and sign
    agreement exactly 1); 1-bit LAMB's ``scale_seg`` and 0/1 Adam's
    ``v_live`` are the reference's.
  * ``audit_stats`` writes nothing of the state it reads (the EF slots
    and the shadow stay bitwise).
  * The probe on a real ``bert-base-smoke`` state: per-segment stats of
    ``SegmentInfo.n``, its gradient the step's own (``grad_norm`` bitwise
    the next step's), ``TrainState`` untouched; it raises under zero1.
  * ``HealthMonitor`` and ``FiniteGuard`` give the reference's verdicts,
    fields and counts; ``MetricBuffer``'s edge cases.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.obs import audit as JA  # noqa: E402
from repro.obs import events as JE  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro.optim.base import SegmentInfo as JSegs  # noqa: E402
from repro.optim.base import segment_cosine as jcos  # noqa: E402
from repro.optim.base import segment_l1 as jl1  # noqa: E402
from repro.optim.base import segment_sign_agreement as jsign  # noqa: E402
from repro.state import StateTree as JTree  # noqa: E402
from repro_torch.obs import audit as PA  # noqa: E402
from repro_torch.obs import events as PE  # noqa: E402
from repro_torch.obs.metrics import MetricBuffer  # noqa: E402
from repro_torch.optim import SegmentInfo, get_optimizer  # noqa: E402
from repro_torch.optim.base import (AUDIT_SCALAR_KEYS,  # noqa: E402
                                    AUDIT_SEG_KEYS, segment_cosine,
                                    segment_l1, segment_sign_agreement)
from repro_torch.state import StateTree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SIGN_SLACK = 2        # coordinates a sign_agree case may differ by

LAYOUTS = {"one": (256,), "three": (64, 128, 64), "ragged": (64, 64, 192,
                                                           192)}


def _state(sizes, rng, count=None, srv_div=2):
    d = sum(sizes)
    f = {"m": rng.normal(size=d).astype(np.float32),
         "v": rng.uniform(0.1, 1.0, d).astype(np.float32),
         "worker_err": (0.1 * rng.normal(size=d)).astype(np.float32),
         "server_err": (0.1 * rng.normal(size=d // srv_div)
                        ).astype(np.float32),
         "scale": np.arange(1.0, len(sizes) + 1.0).astype(np.float32),
         "count": np.int32(5 if count is None else count)}
    return f


def _pair(f):
    return (StateTree({k: torch.from_numpy(np.array(v)) for k, v in
                       f.items()}),
            JTree({k: jnp.asarray(v) for k, v in f.items()}))


def _opts(name, comp, **kw):
    ckw = {"block_size": 64} if comp == "onebit" else None
    return (get_optimizer(name, compressor=comp, compressor_kwargs=ckw, **kw),
            jget_optimizer(name, compressor=comp, compressor_kwargs=ckw,
                           **kw))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_stats_match_reference(layout, seed):
    sizes = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    a = rng.normal(size=sum(sizes)).astype(np.float32)
    b = rng.normal(size=sum(sizes)).astype(np.float32)
    b[:8] = 0.0                                  # a zero stretch
    segs, jsegs = SegmentInfo(sizes), JSegs(sizes)
    ids, n = jsegs.ids(), jsegs.n
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(segment_l1(ta, segs), jl1(ja, ids, n),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(segment_cosine(ta, tb, segs),
                               jcos(ja, jb, ids, n), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(segment_sign_agreement(ta, tb, segs),
                                  np.asarray(jsign(ja, jb, ids, n)))
    zero = torch.zeros_like(ta)
    np.testing.assert_array_equal(segment_cosine(zero, tb, segs),
                                  np.ones(len(sizes)))


@pytest.mark.parametrize("comp", ["identity", "onebit"])
@pytest.mark.parametrize("name,kw", [
    ("onebit_adam", {}), ("onebit_lamb", {}),
    ("zerone_adam", {"var_update_interval": 16, "var_freeze_step": 100})])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_audit_stats_match_reference(comp, name, kw, layout):
    sizes = LAYOUTS[layout]
    rng = np.random.default_rng(len(sizes) * 7 + len(name))
    f = _state(sizes, rng)
    g = rng.normal(size=sum(sizes)).astype(np.float32)
    shadow = rng.uniform(0.1, 1.0, sum(sizes)).astype(np.float32)
    (pst, jst), (popt, jopt) = _pair(f), _opts(name, comp, **kw)
    keep = {k: v.clone() for k, v in pst.items()}
    tshadow = torch.from_numpy(shadow)
    psv, ps = popt.audit_stats(torch.from_numpy(g), pst, tshadow,
                               segs=SegmentInfo(sizes))
    jsv, js = jopt.audit_stats(jnp.asarray(g), jst, jnp.asarray(shadow),
                               segs=JSegs(sizes))
    np.testing.assert_allclose(psv, np.asarray(jsv), rtol=RTOL, atol=ATOL)
    keys = set(AUDIT_SEG_KEYS) | set(AUDIT_SCALAR_KEYS) | \
        set(popt.audit_extra_keys)
    assert set(ps) == set(js) == keys
    for k in sorted(keys - {"sign_agree"}):
        np.testing.assert_allclose(ps[k], np.asarray(js[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # a fraction of each segment's coordinates: how many coordinates
    # differ, per segment
    off = np.abs(np.asarray(ps["sign_agree"]) - np.asarray(js["sign_agree"]))
    assert (np.rint(off * np.asarray(sizes)) <= SIGN_SLACK).all(), off
    if comp == "identity":
        np.testing.assert_array_equal(ps["cos_sim"], np.ones(len(sizes)))
        np.testing.assert_array_equal(ps["sign_agree"],
                                      np.ones(len(sizes)))
    # observation only: the state and the shadow are untouched
    for k, v in keep.items():
        assert torch.equal(pst[k], v), k
    assert torch.equal(tshadow, torch.from_numpy(shadow))


@pytest.mark.parametrize("count,want", [(5, 1.0), (100, 1.0), (500, 0.0)])
def test_zerone_v_live_follows_the_freeze_schedule(count, want):
    rng = np.random.default_rng(4)
    f = _state((64,), rng, count=count)
    (pst, jst) = _pair(f)
    popt, jopt = _opts("zerone_adam", "identity", var_update_interval=16,
                       var_freeze_step=100)
    g = np.zeros(64, np.float32)
    got = float(popt.audit_stats(torch.from_numpy(g), pst, pst.v,
                                 segs=SegmentInfo((64,)))[1]["v_live"])
    ref = float(jopt.audit_stats(jnp.asarray(g), jst, jst["v"],
                                 segs=JSegs((64,)))[1]["v_live"])
    assert got == ref == want
    frozen, _ = _opts("zerone_adam", "identity", var_update_interval=0)
    assert float(frozen.audit_stats(torch.from_numpy(g), pst, pst.v)[1]
                 ["v_live"]) == 0.0


def test_lamb_surfaces_frozen_trust_ratios():
    popt, jopt = _opts("onebit_lamb", "identity")
    assert popt.audit_extra_keys == jopt.audit_extra_keys == ("scale_seg",)
    pst, _ = _pair(_state((32, 32), np.random.default_rng(3)))
    _, stats = popt.audit_stats(torch.zeros(64), pst, pst.v,
                                segs=SegmentInfo((32, 32)))
    assert torch.equal(stats["scale_seg"], pst.scale)


def test_audit_stats_refuses_the_zero1_state():
    opt, _ = _opts("onebit_adam", "identity")
    st = StateTree({"m": torch.zeros(8), "v_shard": torch.zeros(4)})
    with pytest.raises(ValueError, match="full 'v' slot"):
        opt.audit_stats(torch.zeros(8), st, torch.zeros(8))


@pytest.fixture(scope="module")
def smoke():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import init_train_state
    cfg = get_config("bert-base-smoke")
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": 512})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ts = init_train_state(cfg, params, opt, 512)
    stream = SyntheticStream(cfg, InputShape("t", 16, 2, "train"))
    return cfg, opt, ts, stream


def test_probe_is_the_steps_gradient_and_writes_nothing(smoke):
    from repro_torch.train.step import train_step
    _, opt, ts, stream = smoke
    train_step(ts, opt, stream.batch_at(0), 1e-3, "warmup")
    probe = PA.make_audit_probe(ts, opt)
    assert probe.stat_keys == AUDIT_SEG_KEYS + AUDIT_SCALAR_KEYS
    before = {"x": ts.x.clone(), "g": ts.g.clone(),
              **{k: v.clone() for k, v in ts.opt.items()}}
    shadow = ts.opt.v.clone()
    new_sv, stats = probe(stream.batch_at(1), shadow)
    for k, v in before.items():
        got = ts.x if k == "x" else ts.g if k == "g" else ts.opt[k]
        assert torch.equal(got, v), k
    for k in AUDIT_SEG_KEYS:
        assert stats[k].shape == (ts.segs.n,), k
        assert torch.isfinite(stats[k]).all(), k
    assert new_sv.shape == shadow.shape
    # the model's grads point back at ts.g, and the probe's gradient is
    # the one the step then computes
    metrics = train_step(ts, opt, stream.batch_at(1), 1e-3, "compressed")
    assert float(stats["grad_norm"]) == float(metrics["grad_norm"])
    for p in ts.model.parameters():
        assert p.grad.data_ptr() >= ts.g.data_ptr()


def test_probe_rejects_the_zero1_layout(smoke):
    from repro_torch.train.step import seed_zero1
    cfg, opt, ts, _ = smoke
    import copy
    z = copy.copy(ts)
    seed_zero1(z, opt)
    with pytest.raises(ValueError, match="zero1"):
        PA.make_audit_probe(z, opt)


def _fid(**kw):
    base = {"v_drift": [1.0, 1.0], "v_live": 0.0, "v_ratio": 1.0,
            "cos_sim": [0.9, 1.0], "sign_agree": [1.0, 1.0],
            "worker_err_norm": 1.0, "server_err_norm": 0.5}
    base.update(kw)
    return base


SCENARIOS = {
    "healthy": [_fid()],
    "drift": [_fid(v_drift=[1.0, 3.5])],
    "drift_live": [_fid(v_drift=[1.0, 3.5], v_live=1.0)],
    "ef_blowup": [_fid(), _fid(worker_err_norm=50.0)],
    "non_finite": [_fid(cos_sim=[float("nan"), 1.0])],
    "loss_spike": [_fid()],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_health_verdicts_match_reference(name):
    mons = (PA.HealthMonitor(), JA.HealthMonitor())
    outs = []
    for mon in mons:
        for s, loss in enumerate([2.0, 2.1, 1.9, 2.0, 2.05]):
            mon.observe_loss(s, loss)
        if name == "loss_spike":
            mon.observe_loss(5, 9.0)
        res = [mon.observe(10 + i, fid) for i, fid in
               enumerate(SCENARIOS[name])]
        outs.append(res)
    for (pf, pw), (jf, jw) in zip(*outs):
        jf = dict(jf, source="repro_torch.obs.audit")
        assert pf == jf and pw == jw
        PE.make_event("health", **pf)
        JE.make_event("health", **pf)
    assert (outs[0][-1][0]["ok"]) == (name in ("healthy", "drift_live"))


@pytest.mark.parametrize("samples,cap", [
    ([95.0], 100.0), ([100.0, 110.0, 121.0, 133.0], None),
    ([100.0, 120.0, 130.0, 130.0, 130.0], 1000.0)])
def test_memory_verdicts_match_reference(samples, cap):
    mons = (PA.HealthMonitor(mem_growth_windows=3),
            JA.HealthMonitor(mem_growth_windows=3))
    for i, s in enumerate(samples):
        (pf, pw), (jf, jw) = (m.observe_memory(i, s, s, capacity_bytes=cap)
                              for m in mons)
        assert pf == dict(jf, source="repro_torch.obs.mem") and pw == jw
    assert mons[0].n_mem_failed == mons[1].n_mem_failed


def test_finite_guard_matches_reference():
    rec = {"loss": 1.0, "v_l1": float("nan"), "grad_norm": float("inf"),
           "momentum_norm": 2.0, "stage": "compressed"}
    seen = ([], [])
    out = [g.filter(3, rec, on_reject=lambda *a, _s=s: _s.append(a))
           for g, s in zip((PA.FiniteGuard(), JA.FiniteGuard()), seen)]
    assert out[0] == out[1] == {"loss": 1.0, "momentum_norm": 2.0,
                                "stage": "compressed"}
    assert [k for _, k, _ in seen[0]] == [k for _, k, _ in seen[1]]
    guard = PA.FiniteGuard()
    assert guard.filter(0, {"loss": 1.0}) == {"loss": 1.0}
    assert guard.n_rejected == 0 and PA.AUDIT_MODES == JA.AUDIT_MODES


def test_metric_buffer_edges():
    buf = MetricBuffer()
    buf.push(0, {"v": torch.arange(3.0), "s": torch.tensor(2.0)})
    [(s, rec)] = buf.drain()
    assert s == 0 and rec == {"v": [0.0, 1.0, 2.0], "s": 2.0}
    assert isinstance(rec["s"], float)
    for t in range(5):
        buf.push(t, {"x": torch.tensor(float(t))})
    assert buf.host(2)["x"] == 2.0                # mid-window peek
    out = buf.drain()
    assert [s for s, _ in out] == [0, 1, 2, 3, 4]
    assert [r["x"] for _, r in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
    for t in range(4):                            # the auto switch's way
        buf.push(t, {"v_l1": torch.tensor(10.0 + t)})
        assert buf.host(t)["v_l1"] == 10.0 + t
    assert [s for s, _ in buf.drain()] == [0, 1, 2, 3]
    buf.push(3, {"x": torch.tensor(3.0)})
    assert buf.drain() == [(3, {"x": 3.0})]


def test_fidelity_event_of_a_real_probe_validates(smoke):
    _, opt, ts, stream = smoke
    probe = PA.make_audit_probe(ts, opt)
    buf = MetricBuffer()
    buf.push(7, probe(stream.batch_at(2), ts.opt.v.clone())[1])
    [(s, fid)] = buf.drain()
    assert all(math.isfinite(x) for k in AUDIT_SEG_KEYS for x in fid[k])
    rec = dict(step=s, n_segments=len(fid["cos_sim"]), **fid)
    PE.make_event("fidelity", **rec)
    JE.make_event("fidelity", **rec)
