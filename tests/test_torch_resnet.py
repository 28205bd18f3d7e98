"""The port's ResNet (``repro_torch.models.resnet``) and its optimizer
comparison (``repro_torch.benchmarks.resnet_convergence``) against the
JAX package on the CPU, on the reference's arrays.

  * logits, loss, accuracy and the flat gradient of
    ``repro.models.resnet`` at two widths and image sizes (one odd), rtol
    1e-5 / atol 1e-6 (the convs and the group norm sum in another order);
  * one stride-2 conv alone at sizes 16 and 15: XLA's SAME padding is
    (0, 1) on an even size, which ``F.conv2d(padding=1)`` is not;
  * the flat order is ``ravel_pytree``'s (a block of 256 compressed
    elements covers the reference's coordinates);
  * each of the six runs over 6 steps with ``WARMUP`` 3 (the reference's
    module and the port's, through ``monkeypatch``), from the reference's
    ``init_resnet(PRNGKey(1))`` on its ``_stream(t)`` batches: the
    reference's ``_train`` runs eagerly (``jax.jit`` patched to the
    identity), so its updates can be recorded.  Each update is held from
    the reference's state and gradient: the compressed payload's sign
    bits bitwise, the new state at rtol 1e-6 / atol 1e-6, the new x at
    that tolerance of the terms it is formed from (x and lr * update).  The
    free-running curves agree at rtol 1e-5 through step ``WARMUP`` and
    2e-3 after it (``tests/test_torch_families_steps.py``'s tolerances,
    for its reason), up to the first step whose payload's sign bits
    disagree (counted each step: a bit flips only where the compressed
    value lies within the rounding difference of zero); after it they only
    stay finite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import benchmarks.resnet_convergence as JB  # noqa: E402
from repro.core import comm as JC  # noqa: E402
from repro.core.compression import pack_signs as jpack  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro_torch.benchmarks import resnet_convergence as TB  # noqa: E402
from repro_torch.convert import flat_from_params, params_from_jax  # noqa: E402
from repro_torch.core import comm as TC  # noqa: E402
from repro_torch.core.compression import pack_signs as tpack  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402
from repro_torch.models.common import conv_same  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
X_TOL = dict(rtol=1e-6, atol=1e-6)
# free-running losses, tests/test_torch_families_steps.py's for its reason:
# Adam's first steps turn ULP differences of near-zero gradients into
# update differences (2 lr / sqrt(1 - b2) where a gradient's sign flips)
LOSS_RTOL, LOSS_RTOL_LATE = 1e-5, 2e-3
STEPS, WARMUP = 6, 3
COMPRESSED = ("onebit", "ef_msgd", "naive")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b):
    return {"images": torch.from_numpy(np.array(b["images"])),
            "labels": torch.from_numpy(np.array(b["labels"], np.int64))}


@pytest.mark.parametrize("widths,size", [((16, 32, 64), 16), ((8, 16), 15)])
def test_forward_loss_grad_match_reference(widths, size):
    jp = JR.init_resnet(jax.random.PRNGKey(1), widths)
    jb = JR.synthetic_cifar(jax.random.PRNGKey(0), 8, size=size)
    tp = params_from_jax(_np(jp))
    x, d, shapes = TB.flat_problem(tp)
    with torch.no_grad():
        logits = TR.resnet_apply(tp, _batch(jb)["images"], widths)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(JR.resnet_apply(jp, jb["images"], widths)),
        **TOL)
    (jloss, jacc), jg = jax.jit(jax.value_and_grad(
        lambda p: JR.resnet_loss(p, jb, widths), has_aux=True))(jp)
    loss, g = TB.loss_and_grad(x, d, shapes, _batch(jb), widths)
    with torch.no_grad():
        _, acc = TR.resnet_loss(tp, _batch(jb), widths)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert float(acc) == float(jacc)
    assert torch.equal(g[d:], torch.zeros(x.shape[0] - d))
    np.testing.assert_allclose(g[:d].numpy(),
                               np.asarray(ravel_pytree(jg)[0]), **TOL)


@pytest.mark.parametrize("size", [16, 15])
def test_stride2_conv_matches_reference(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5), dtype=np.float32)
    w = rng.standard_normal((3, 3, 5, 7), dtype=np.float32)
    want = np.asarray(JR._conv(x, w, 2))
    got = conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w), 2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, (size + 1) // 2,
                                       (size + 1) // 2, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flat_order_is_ravel_pytree():
    jp = JR.init_resnet(jax.random.PRNGKey(3))
    x, d, _ = TB.flat_problem(params_from_jax(_np(jp)))
    flat = np.asarray(ravel_pytree(jp)[0])
    assert d == flat.shape[0] and x.shape[0] % TB.BLOCK == 0
    np.testing.assert_array_equal(x[:d].numpy(), flat)
    np.testing.assert_array_equal(
        flat_from_params(params_from_jax(_np(jp))).numpy(), flat)


class _Recorder:
    """Stands in for a module (``OB``, ``M``): each listed function call
    appends its (name, inputs, outputs) to ``calls``."""

    def __init__(self, module, calls):
        self._module, self._calls = module, calls

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if not name.endswith("update"):
            return fn

        def recorded(*args, **kw):
            out = fn(*args, **kw)
            self._calls.append((name, args, out))
            return out
        return recorded


def _payload_spy(pack, store, fn):
    """Wrap ``compressed_allreduce``: the sign bits of x + worker_err."""
    def spied(x, worker_err, *args, **kw):
        store.append(np.asarray(pack(x + worker_err)))
        return fn(x, worker_err, *args, **kw)
    return spied


def _assert_step_close(got, want, x_in, msg):
    """x_new = x_in - lr * upd, held at X_TOL of the terms it is formed
    from: where v is near 0 (the zero padding; coordinates whose warmup
    gradients were ~0) a compressed step moves x by lr * m_bar / (sqrt(v)
    + eps), and the block scale's few-ulp difference (its mean sums in
    another order) is a few ulp of that move, not of the new x."""
    terms = np.abs(x_in) + np.abs(x_in - want)
    bad = np.abs(got - want) > X_TOL["rtol"] * terms + X_TOL["atol"]
    assert not bad.any(), (msg, np.flatnonzero(bad)[:10], got[bad][:5],
                           want[bad][:5])


def _to_torch_state(template, jstate):
    return type(template)(*[torch.from_numpy(np.array(f)) for f in jstate])


@pytest.mark.parametrize("kind", TB.KINDS)
def test_runs_match_reference(kind, monkeypatch):
    monkeypatch.setattr(JB, "WARMUP", WARMUP)
    monkeypatch.setattr(TB, "WARMUP", WARMUP)
    calls, jpay, tpay = [], [], []
    monkeypatch.setattr(JB.jax, "jit", lambda f: f)
    monkeypatch.setattr(JB, "OB", _Recorder(JB.OB, calls))
    monkeypatch.setattr(JB, "M", _Recorder(JB.M, calls))
    monkeypatch.setattr(JC, "compressed_allreduce",
                        _payload_spy(jpack, jpay, JC.compressed_allreduce))
    monkeypatch.setattr(TC, "compressed_allreduce",
                        _payload_spy(tpack, tpay, TC.compressed_allreduce))
    jlosses = JB._train(kind, steps=STEPS)
    jpay_run = list(jpay)

    params = params_from_jax(_np(JR.init_resnet(jax.random.PRNGKey(1))))
    tlosses = TB.train(kind, STEPS, params=params,
                       batches=lambda t: _batch(JB._stream(t)))
    tpay_run = list(tpay)

    # every update from the reference's state and gradient; an update
    # that exchanges takes one payload on each side
    st0, update = TB.make_update(kind, TB.flat_problem(params)[0].shape[0],
                                 "cpu")
    k = 0
    for t, (name, (g, jst, jx, *_), out) in enumerate(calls):
        del tpay[:]
        with torch.no_grad():
            tx, tst = update(torch.from_numpy(np.array(jx)),
                             _to_torch_state(st0, jst),
                             torch.from_numpy(np.array(g)), t)
        if tpay:
            np.testing.assert_array_equal(tpay[0], jpay_run[k],
                                          err_msg=f"{kind} step {t}")
            k += 1
        _assert_step_close(tx.numpy(), np.asarray(out[0]), np.asarray(jx),
                           f"{kind} step {t}")
        for field, a, b in zip(out[1]._fields, tst, out[1]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **X_TOL,
                                       err_msg=f"{kind} step {t} {field}")
    assert k == len(jpay_run) == len(tpay_run)
    assert len(calls) == (0 if kind == "sgd" else STEPS)

    # the free-running curves: sign bits apart in each step's payload
    flips = [int(np.unpackbits(a ^ b).sum())
             for a, b in zip(jpay_run, tpay_run)]
    print(kind, "payload sign bits apart a step", flips, "losses port",
          tlosses, "reference", jlosses)
    first = STEPS
    if kind in COMPRESSED:
        lo = STEPS - len(flips)         # the first compressed step
        first = next((lo + i + 1 for i, n in enumerate(flips) if n), STEPS)
    assert all(np.isfinite(tlosses))
    for lo, hi, rtol in ((0, min(first, WARMUP + 1), LOSS_RTOL),
                         (WARMUP + 1, first, LOSS_RTOL_LATE)):
        if lo < hi:
            np.testing.assert_allclose(tlosses[lo:hi], jlosses[lo:hi],
                                       rtol=rtol)
