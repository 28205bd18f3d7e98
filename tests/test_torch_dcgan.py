"""The port's DCGAN (``repro_torch.models.dcgan``) and its 1-bit Adam
driver (``repro_torch.benchmarks.dcgan_convergence._Opt``) against the JAX
package on the CPU, on the reference's arrays.

  * ``generator``, ``discriminator``, ``d_loss``, ``g_loss`` and the
    gradients of ``d_loss`` (in the discriminator only: ``fake`` carries
    no gradient) and ``g_loss`` (in the generator only), rtol 1e-5 / atol
    1e-6 (the convs and the group norm sum in another order);
  * ``_deconv`` alone on non-symmetric random weights: the reference's
    ``conv_transpose`` does not flip the kernel, ``F.conv_transpose2d``
    does;
  * 4 ``_Opt`` steps of adam and onebit with ``WARMUP`` 2 (both modules,
    through ``monkeypatch``), each from the reference's state on the
    reference's gradients: the new x and state at rtol 1e-6 / atol 1e-6
    of the terms each is formed from, the compressed payload's sign bits
    bitwise; and the port's own 4-step run finite;
  * ``synthetic_faces``: shape and range [-1, 1].
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import benchmarks.dcgan_convergence as JB  # noqa: E402
from repro.core import comm as JC  # noqa: E402
from repro.core.compression import pack_signs as jpack  # noqa: E402
from repro.models import dcgan as JD  # noqa: E402
from repro_torch.benchmarks import dcgan_convergence as TB  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import comm as TC  # noqa: E402
from repro_torch.core.compression import pack_signs as tpack  # noqa: E402
from repro_torch.models import dcgan as TD  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
X_TOL = dict(rtol=1e-6, atol=1e-6)
STEPS, WARMUP = 4, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref():
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    pg, pd = JD.init_generator(kg, TB.Z), JD.init_discriminator(kd)
    z = jax.random.normal(jax.random.PRNGKey(5), (8, TB.Z))
    real = JD.synthetic_faces(jax.random.PRNGKey(6), 8)
    return pg, pd, z, real


def test_networks_losses_and_grads_match_reference(ref):
    pg, pd, z, real = ref
    tg, td = params_from_jax(_np(pg)), params_from_jax(_np(pd))
    tz, treal = _t(z), _t(real)
    with torch.no_grad():
        fake = TD.generator(tg, tz)
        np.testing.assert_allclose(fake.numpy(),
                                   np.asarray(JD.generator(pg, z)), **TOL)
        assert fake.shape == (8, 16, 16, 3)
        np.testing.assert_allclose(
            TD.discriminator(td, treal).numpy(),
            np.asarray(JD.discriminator(pd, real)), **TOL)
        np.testing.assert_allclose(
            float(TD.d_loss(td, tg, treal, tz)),
            float(JD.d_loss(pd, pg, real, z)), **TOL)
        np.testing.assert_allclose(float(TD.g_loss(tg, td, tz)),
                                   float(JD.g_loss(pg, pd, z)), **TOL)
    od, og = TB._Opt(td, "adam", TB.LR), TB._Opt(tg, "adam", TB.LR)
    gd = od.grad(lambda p: TD.d_loss(p, tg, treal, tz))
    gg = og.grad(lambda p: TD.g_loss(p, td, tz))
    for got, want, opt in (
            (gd, jax.grad(JD.d_loss)(pd, pg, real, z), od),
            (gg, jax.grad(JD.g_loss)(pg, pd, z), og)):
        assert torch.equal(got[opt.d:], torch.zeros(opt.dp - opt.d))
        np.testing.assert_allclose(got[:opt.d].numpy(),
                                   np.asarray(ravel_pytree(want)[0]), **TOL)


def test_deconv_matches_reference_unflipped():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 6), dtype=np.float32)
    w = rng.standard_normal((4, 4, 6, 5), dtype=np.float32)
    want = np.asarray(JD._deconv(x, w))
    got = TD._deconv(_t(x).permute(0, 3, 1, 2), _t(w)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 8, 8, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _terms_close(got, want, x_in, msg):
    """``x_in - lr * upd`` at X_TOL of the terms it is formed from."""
    terms = np.abs(x_in) + np.abs(x_in - want)
    bad = np.abs(got - want) > X_TOL["rtol"] * terms + X_TOL["atol"]
    assert not bad.any(), (msg, np.flatnonzero(bad)[:10])


def _payload_spy(pack, store, fn):
    """Wrap ``compressed_allreduce``: the sign bits of x + worker_err."""
    def spied(x, worker_err, *args, **kw):
        store.append(np.asarray(pack(x + worker_err)))
        return fn(x, worker_err, *args, **kw)
    return spied


@pytest.mark.parametrize("kind", ["adam", "onebit"])
def test_opt_steps_from_reference_state(kind, ref, monkeypatch):
    monkeypatch.setattr(JB, "WARMUP", WARMUP)
    monkeypatch.setattr(TB, "WARMUP", WARMUP)
    jpay, tpay = [], []
    monkeypatch.setattr(JC, "compressed_allreduce",
                        _payload_spy(jpack, jpay, JC.compressed_allreduce))
    monkeypatch.setattr(TC, "compressed_allreduce",
                        _payload_spy(tpack, tpay, TC.compressed_allreduce))
    pg, pd, z, real = ref
    jg, jd = JB._Opt(pg, kind, TB.LR), JB._Opt(pd, kind, TB.LR)
    tg = TB._Opt(params_from_jax(_np(pg)), kind, TB.LR)
    td = TB._Opt(params_from_jax(_np(pd)), kind, TB.LR)
    assert (tg.d, tg.dp, td.d, td.dp) == (jg.d, jg.dp, jd.d, jd.dp)
    for t in range(STEPS):
        grads = {"d": jax.grad(JB.d_loss)(jd.params(), jg.params(), real,
                                          z)}
        grads["g"] = jax.grad(JB.g_loss)(jg.params(), jd.params(), z)
        for name, jo, to in (("d", jd, td), ("g", jg, tg)):
            to.x = _t(jo.x)
            to.st = type(to.st)(*[_t(f) for f in jo.st])
            x_in, g = np.asarray(jo.x), ravel_pytree(grads[name])[0]
            jo.step(grads[name], t)
            to.step(_t(np.pad(np.asarray(g), (0, jo.dp - jo.d))), t)
            msg = f"{kind} {name} step {t}"
            assert len(jpay) == len(tpay) == int(
                kind == "onebit" and t >= WARMUP), msg
            if jpay:
                np.testing.assert_array_equal(tpay.pop(), jpay.pop(),
                                              err_msg=msg)
            _terms_close(to.x.numpy(), np.asarray(jo.x), x_in, msg)
            for field, a, b in zip(jo.st._fields, to.st, jo.st):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **X_TOL, err_msg=f"{msg} {field}")
    assert int(td.st.count) == STEPS
    if kind == "onebit":
        assert float(torch.linalg.vector_norm(td.st.worker_err)) > 0


@pytest.mark.parametrize("kind", ["adam", "onebit"])
def test_port_run_few_steps(kind, monkeypatch):
    monkeypatch.setattr(TB, "WARMUP", WARMUP)
    out = TB._train(kind, steps=STEPS)
    assert set(out) == {"g_final", "d_final", "stat_err"}
    assert all(np.isfinite(v) for v in out.values())


def test_synthetic_faces_shape_and_range():
    x = TD.synthetic_faces(np.random.default_rng(0), 32)
    assert x.shape == (32, 16, 16, 3) and x.dtype == torch.float32
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    assert float(x.std()) > 0.05
