"""The port's 1-bit Adam against the JAX optimizer on the same flat vectors.

``repro.optim.get_optimizer("onebit_adam")`` (jnp path) and the port's
optimizer (plain versions on CPU tensors) run 3 warmup then 3 compressed
steps on the same numpy gradients.  The port's warmup update computes in
the order of the fused kernel, ``(1-b2)*g*g``, where the jnp path squares
first; the block scales are means summed in another order.  Both differ
at the ULP and compound over the steps, so the states agree to rtol 1e-5
with an atol of 1e-6 times the scale of the vector (1e-5 times the scale
of ``m`` for the EF residuals, see below); ``v`` stays bitwise frozen
through the compressed steps.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import WarmupSwitch as JSwitch  # noqa: E402
from repro.optim import get_optimizer as jget  # noqa: E402
from repro_torch.optim import WarmupSwitch as TSwitch  # noqa: E402
from repro_torch.optim import get_optimizer as tget  # noqa: E402

BLOCK = 512


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("bias_correction", [False, True])
def test_chained_steps_match_reference(seed, wd, bias_correction):
    """bias_correction=True leaves the fused-Adam gate: the warmup then
    takes the plain bias-corrected chain, as the reference's jnp path."""
    rng = np.random.default_rng(seed)
    d = 8 * BLOCK
    x0 = rng.standard_normal(d).astype(np.float32)
    grads = [(rng.standard_normal(d) * 0.1).astype(np.float32)
             for _ in range(6)]
    hyper = dict(weight_decay=wd, bias_correction=bias_correction)
    jopt = jget("onebit_adam", compressor="onebit",
                compressor_kwargs={"block_size": BLOCK}, **hyper)
    topt = tget("onebit_adam", compressor="onebit",
                compressor_kwargs={"block_size": BLOCK}, **hyper)
    assert topt._fused_warmup_ok is not bias_correction
    jst, tst = jopt.init_state(d), topt.init_state(d)
    assert list(tst) == [k for k in jst if k in tst]
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0.copy())
    lr = 1e-3
    for step, g in enumerate(grads):
        jg, tg = jnp.asarray(g), torch.from_numpy(g)
        if step < 3:
            jx, jst, jstats = jopt.warmup_update(jg, jst, jx,
                                                 jnp.float32(lr))
            tx, tst, tstats = topt.warmup_update(tg, tst, tx, lr)
        else:
            v_before = tst.v.clone()
            jx, jst, jstats = jopt.update(jg, jst, jnp.float32(lr), x=jx)
            tx, tst, tstats = topt.update(tg, tst, lr, x=tx)
            assert torch.equal(tst.v, v_before)
        _close(tx.numpy(), jx, 1.0)
        # the EF residuals are differences of nearly equal numbers (the
        # single-rank server residual is pure rounding: +-scale minus its
        # own re-compression), so the scales' ULP differences show at
        # 10 ULP of the scale: hold them to 1e-5 of the m scale
        m_scale = float(np.abs(np.asarray(jst["m"])).max())
        v_scale = float(np.abs(np.asarray(jst["v"])).max())
        for k, scale in (("m", m_scale), ("v", v_scale),
                         ("worker_err", 10 * m_scale),
                         ("server_err", 10 * m_scale)):
            _close(tst[k].numpy(), np.asarray(jst[k]), scale)
        assert int(tst.count) == int(jst.count) == step + 1
        for k, v in tstats.items():
            # the residual norms are rounding-level on the server side
            abs_tol = 1e-6 if k.endswith("err_norm") else 1e-7
            assert math.isclose(float(v), float(jstats[k]), rel_tol=1e-5,
                                abs_tol=abs_tol), (step, k)


@pytest.mark.parametrize("warmup_steps", [0, 1, 3])
def test_switch_steps_mode_matches_reference(warmup_steps):
    j = JSwitch(mode="steps", warmup_steps=warmup_steps)
    t = TSwitch(mode="steps", warmup_steps=warmup_steps)
    for step in range(6):
        assert t.compressed(step) == j.compressed(step) == \
            (step >= warmup_steps)
        assert t.observe(step, {}) == j.observe(step, {})
        assert t.switch_step == j.switch_step


@pytest.mark.parametrize("series", [
    [1.0, 1.5, 1.8, 1.9, 1.95, 1.97, 1.98],
    [1.0, float("nan"), 1.5, 1.9, 1.98, 2.0, 2.0],
    [1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
])
def test_switch_auto_mode_matches_reference(series):
    """The Sec. 7.1 rule with Delta = 1/(1-b2) = 2 and 2 LR-warmup steps,
    non-finite v_l1 rejected."""
    j = JSwitch(mode="auto", b2=0.5, threshold=0.96, lr_warmup_steps=2)
    t = TSwitch(mode="auto", b2=0.5, threshold=0.96, lr_warmup_steps=2)
    jw, tw = [], []
    for step, v in enumerate(series):
        assert t.compressed(step) == j.compressed(step)
        assert t.observe(step, {"v_l1": v},
                         on_warning=lambda s, m: tw.append(s)) == \
            j.observe(step, {"v_l1": v},
                      on_warning=lambda s, m: jw.append(s))
        assert t.switch_step == j.switch_step
    assert tw == jw
    assert t.monitor.n_rejected == j.monitor.n_rejected
