"""The port's optimizer family against the JAX optimizers, step by step.

Each step feeds the SAME numpy ``g``/``x``/state (the reference's state
after the previous step) to ``repro.optim.get_optimizer(...)`` (jnp path,
``dp_axes=()``) and to the port's optimizer (plain versions on CPU
tensors), for 6 steps covering 1-bit LAMB (warmup and compressed, with
``SegmentInfo((1024, 1024))`` as ``tests/test_optim_registry.py``), 0/1
Adam (interval 2, sync doubling: 0-bit and sync steps, ``v`` refreshed),
1-bit Adam over top-k and identity, and bias correction.

Tolerances, and why:
  * sign payloads are bitwise (the same inputs; a sign flips only where
    the momentum is exactly at a rounding boundary of zero);
  * top-k: decompressed values and the EF identity ``decompress(payload)
    + new_err == x + err`` are exact; the kept indices are bitwise where
    the kept set is unique (the zero padding block ties, and
    ``torch.topk`` and ``jax.lax.top_k`` may keep other zeros);
  * floats: ``tests/test_kernels.py``'s, rtol 1e-5 with atol 1e-6 times
    the vector's scale for parameters and moments (the fused Adam order
    ``(1-b2)*g*g`` against the jnp chain's, segment sums in another order
    than ``segment_sum``); EF residuals atol 1e-5 of the momentum's scale
    (differences of nearly equal numbers, as
    ``tests/test_torch_optim.py``); stats rtol 1e-5 / atol 1e-6.
    Counters exact.

Also: ``zero1`` against ``replicated`` in the port (bitwise masters on one
process, as ``tests/test_optim_registry.py::TestZero1Parity``), and the
slot declarations, ``state_bytes`` and ``layout_manifest`` equal to the
reference's for all three layouts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import get_optimizer as jget  # noqa: E402
from repro.optim.base import SegmentInfo as JSeg  # noqa: E402
from repro.state import StateLayout as JLayout  # noqa: E402
from repro.state import StateTree as JTree  # noqa: E402
from repro.state import layout_manifest as jmanifest  # noqa: E402
from repro.state import state_bytes as jstate_bytes  # noqa: E402
from repro_torch.optim import get_optimizer as tget  # noqa: E402
from repro_torch.optim.base import SegmentInfo as TSeg  # noqa: E402
from repro_torch.state import StateLayout as TLayout  # noqa: E402
from repro_torch.state import StateTree as TTree  # noqa: E402
from repro_torch.state import layout_manifest as tmanifest  # noqa: E402
from repro_torch.state import state_bytes as tstate_bytes  # noqa: E402

D = 2048
BLOCK = 256
SIZES = (1024, 1024)
LR = 1e-2


def _rand(seed, scale=1.0, d=D):
    return (np.random.default_rng(seed).standard_normal(d)
            * scale).astype(np.float32)


def _opts(name, compressor="onebit", **hyper):
    kw = dict(compressor=compressor, compressor_kwargs={"block_size": BLOCK},
              **hyper)
    return jget(name, **kw), tget(name, **kw)


def _step(jopt, topt, stage, x, state, g, segs, sync=True):
    """One step of both from the same numpy inputs -> numpy outputs."""
    jst = JTree({k: jnp.asarray(v) for k, v in state.items()})
    tst = TTree({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    js = JSeg(segs) if segs else None
    ts = TSeg(segs) if segs else None
    if stage == "warmup":
        jx, jst, jstats = jopt.warmup_update(jnp.asarray(g), jst,
                                             jnp.asarray(x), jnp.float32(LR),
                                             segs=js)
        tx, tst, tstats = topt.warmup_update(torch.from_numpy(g.copy()), tst,
                                             torch.from_numpy(x.copy()), LR,
                                             segs=ts)
    else:
        jx, jst, jstats = jopt.update(jnp.asarray(g), jst, jnp.float32(LR),
                                      x=jnp.asarray(x), segs=js, sync=sync)
        tx, tst, tstats = topt.update(torch.from_numpy(g.copy()), tst, LR,
                                      x=torch.from_numpy(x.copy()), segs=ts,
                                      sync=sync)
    jout = (np.asarray(jx), {k: np.asarray(v) for k, v in jst.items()},
            {k: float(v) for k, v in jstats.items()})
    tout = (tx.numpy(), {k: v.numpy() for k, v in tst.items()},
            {k: float(v) for k, v in tstats.items()})
    return jout, tout


def _close(got, want, scale, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _check(jout, tout):
    (jx, jst, jstats), (tx, tst, tstats) = jout, tout
    assert list(tst) == list(jst)
    _close(tx, jx, float(np.abs(jx).max()))
    m_scale = float(np.abs(jst["m"]).max()) or 1.0
    for k in jst:
        if jst[k].dtype == np.int32:
            np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
        elif k.endswith("err"):
            _close(tst[k], jst[k], 10 * m_scale)
        else:
            _close(tst[k], jst[k], float(np.abs(jst[k]).max()) or 1.0)
    for k, v in jstats.items():
        assert np.isclose(tstats[k], v, rtol=1e-5, atol=1e-6), (k, tstats, v)


def _payload_bits_equal(jopt, topt, state, g):
    """The worker payload of this compressed step, from the same m_local
    and worker_err on both sides, is bitwise the reference's."""
    m_local = (0.9 * state["m"] + (1.0 - 0.9) * g).astype(np.float32)
    jp, jerr = jopt.compressor.ef_compress(jnp.asarray(m_local),
                                           jnp.asarray(state["worker_err"]))
    tp, terr = topt.compressor.ef_compress(torch.from_numpy(m_local),
                                           torch.from_numpy(
                                               state["worker_err"].copy()))
    return [np.asarray(a) for a in jp], [b.numpy() for b in tp], \
        np.asarray(jerr), terr.numpy()


def _run(name, stages, compressor="onebit", segs=SIZES, syncs=None,
         pad_block=False, **hyper):
    jopt, topt = _opts(name, compressor, **hyper)
    state = {k: np.asarray(v) for k, v in
             jopt.init_state(D, 1, len(segs) if segs else 1).items()}
    assert list(topt.init_state(D, 1, len(segs) if segs else 1)) == \
        list(state)
    x = _rand(100)
    if pad_block:                  # a zero padding block, as d_pad's tail
        x[-BLOCK:] = 0.0
    syncs = syncs or [True] * len(stages)
    for i, (stage, sync) in enumerate(zip(stages, syncs)):
        g = _rand(i, 0.1)
        if pad_block:
            g[-BLOCK:] = 0.0
        if stage == "compressed" and sync:
            jp, tp, jerr, terr = _payload_bits_equal(jopt, topt, state, g)
            if compressor == "onebit":
                np.testing.assert_array_equal(tp[0], jp[0])
            elif compressor == "topk":
                jdec = np.asarray(jopt.compressor.decompress(
                    tuple(jnp.asarray(a) for a in jp)))
                tdec = topt.compressor.decompress(
                    tuple(torch.from_numpy(a) for a in tp)).numpy()
                np.testing.assert_array_equal(tdec, jdec)
                np.testing.assert_array_equal(tp[0], jp[0])
                buf = (0.9 * state["m"] + 0.1 * g).astype(np.float32) \
                    + state["worker_err"]
                np.testing.assert_array_equal(tdec + terr, buf)
                k = topt.compressor.k
                nb = D // BLOCK
                ti, ji = tp[1].reshape(nb, k), jp[1].reshape(nb, k)
                live = slice(0, nb - 1) if pad_block else slice(0, nb)
                np.testing.assert_array_equal(ti[live], ji[live])
        jout, tout = _step(jopt, topt, stage, x, state, g, segs, sync)
        _check(jout, tout)
        x, state = jout[0], jout[1]
    return state


W, C = "warmup", "compressed"


def test_onebit_lamb_warmup_and_compressed():
    state = _run("onebit_lamb", [W, W, W, C, C, C])
    assert (state["scale"] > 0).all()       # frozen at the first C step


def test_onebit_lamb_without_segments_is_adam():
    _run("onebit_lamb", [W, W, W, C, C, C], segs=None)


def test_zerone_adam_zero_bit_and_sync_steps():
    jopt, topt = _opts("zerone_adam", var_update_interval=2,
                       sync_double_every=1, sync_max_interval=2)
    syncs = [True, True] + [topt.sync_due(i) for i in range(4)]
    assert syncs[2:] == [True, False, True, False]
    assert [jopt.sync_due(i) for i in range(4)] == syncs[2:]
    assert topt.may_skip_sync and jopt.may_skip_sync
    state = _run("zerone_adam", [W, W, C, C, C, C], syncs=syncs,
                 var_update_interval=2, sync_double_every=1,
                 sync_max_interval=2)
    assert int(state["v_step"]) == 5         # refreshed at counts 3 and 5


def test_zerone_adam_every_step_syncs():
    """No skipping: v refreshes from g_hat = (m_bar - b1 m_prev)/(1-b1)."""
    state = _run("zerone_adam", [W, W, C, C, C, C], var_update_interval=2,
                 sync_double_every=0)
    assert int(state["v_step"]) == 5         # refreshed at counts 3 and 5


@pytest.mark.parametrize("compressor", ["topk", "identity"])
def test_onebit_adam_other_compressors(compressor):
    _run("onebit_adam", [W, W, W, C, C, C], compressor=compressor,
         pad_block=True)


@pytest.mark.parametrize("name", ["onebit_adam", "onebit_lamb"])
def test_bias_correction(name):
    _, topt = _opts(name, bias_correction=True)
    assert not topt._fused_warmup_ok
    _run(name, [W, W, W, C, C, C], bias_correction=True, weight_decay=0.01)


def test_fused_warmup_gate():
    """The fused Adam kernel only where it computes the warmup exactly:
    no bias correction and no direction-shaping hook (not 1-bit LAMB)."""
    assert tget("onebit_adam")._fused_warmup_ok
    assert tget("zerone_adam")._fused_warmup_ok
    assert not tget("onebit_lamb")._fused_warmup_ok


@pytest.mark.parametrize("name", ["onebit_adam", "zerone_adam",
                                  "onebit_lamb"])
def test_zero1_matches_replicated(name):
    """The port's zero1 update against its replicated one on one process:
    bitwise masters, m, v and scale (tests/test_optim_registry.py:314)."""
    segs = TSeg(SIZES)
    opt = tget(name, compressor="onebit",
               compressor_kwargs={"block_size": BLOCK})
    v0 = torch.from_numpy(np.abs(_rand(11)) + 0.1)
    m0 = torch.from_numpy(_rand(12, 0.1))
    x0 = torch.from_numpy(_rand(13))
    st_r = opt.init_state(D, 1, segs.n)._replace(m=m0, v=v0)
    st_z = opt.init_state(D, 1, segs.n, layout="zero1")._replace(
        m=m0, v_shard=v0, master_shard=x0)
    x_r = x0
    for i in range(6):
        g = torch.from_numpy(_rand(20 + i, 0.1))
        x_r, st_r, _ = opt.update(g, st_r, LR, x=x_r, segs=segs)
        xf, st_z, _ = opt.update(g, st_z, LR, segs=segs)
        assert torch.equal(st_z.master_shard, x_r)
        assert torch.equal(st_z.m, st_r.m)
        assert torch.equal(st_z.v_shard, st_r.v)
        assert torch.equal(st_z.scale, st_r.scale)
        assert xf.dtype == torch.bfloat16
        assert torch.equal(xf, x_r.to(torch.bfloat16))


@pytest.mark.parametrize("layout", ["replicated", "local", "zero1"])
@pytest.mark.parametrize("n_dp,n_srv", [(1, 1), (4, 4), (4, 2)])
def test_slot_declarations_match_reference(layout, n_dp, n_srv):
    jopt, topt = _opts("onebit_lamb")
    js, ts = jopt.state_slots(layout), topt.state_slots(layout)
    assert [s.manifest() for s in ts] == [s.manifest() for s in js]
    d = 4 * n_dp * BLOCK
    kw = dict(d=d, n_dp=n_dp, n_srv=n_srv, n_outer=n_dp // n_srv,
              n_segments=3, dp_sizes=(n_dp // n_srv, n_srv) if n_srv <
              n_dp else (n_dp,), tp=1)
    jctx, tctx = JLayout(**kw), TLayout(**kw)
    assert tstate_bytes(ts, tctx) == jstate_bytes(js, jctx)
    assert tmanifest(ts, tctx, block=BLOCK) == \
        jmanifest(js, jctx, block=BLOCK)
    jst = jopt.init_state(d, n_dp, 3, n_inner=n_srv, layout=layout)
    tst = topt.init_state(d, n_dp, 3, n_inner=n_srv, layout=layout)
    assert {k: tuple(v.shape) for k, v in tst.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}
