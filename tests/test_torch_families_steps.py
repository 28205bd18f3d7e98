"""The optimizer path of the model families against the JAX reference,
step by step, on the CPU: 3 warmup + 2 compressed 1-bit Adam steps of a
MoE (``mixtral-8x22b-smoke``), the SSM (``falcon-mamba-7b-smoke``) and
the hybrid (``jamba-1.5-large-398b-smoke``) through the port's
``train_step`` and the reference's ``make_train_step`` on a 1 x 1 mesh,
the pattern of ``tests/test_torch_slice.py::test_port_steps_match_reference``,
with its tolerances for its reasons: losses through step 3 rtol 2e-5
(Adam's first steps turn ULP differences of the gradient into small
update differences), the first compressed payload at most 1e-3 of its
sign bits apart (a bit flips only where the local momentum lies within
the accumulated rounding difference of zero), later losses rtol 2e-3
(each flipped sign moves its coordinate by 2 * scale / sqrt(v)).  Then a
checkpoint of a MoE arch written by the port loads in the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.core.compression import pack_signs as jpack  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro.state import load_train_state as jload  # noqa: E402
from repro.train.step import (TrainStepConfig, flat_grads,  # noqa: E402
                              init_train_state as jinit_state,
                              make_train_step)
from repro_torch.checkpoint import flatten_with_keys  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flat_from_params, params_from_flat, params_from_jax, params_to_jax)
from repro_torch.core.compression import pack_signs as tpack  # noqa: E402
from repro_torch.launch.train import lr_schedule, run  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.train.step import (flat_dim, init_train_state,  # noqa: E402
                                    train_step)

BLOCK = 512
WARMUP, STEPS = 3, 5
BASE_LR, LR_WARMUP = 2e-3, 2
LOSS_RTOL = 1e-5                 # loss_fn's (tests/test_torch_model.py)
GRAD_RTOL = 1e-4
GRAD_ATOL_SHARE = 1e-5
LOSS_RTOL_WARMUP = 2e-5
LOSS_RTOL_COMPRESSED = 2e-3
SIGN_FLIP_CEILING = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _bits_disagree(a: np.ndarray, b: np.ndarray) -> float:
    diff = np.unpackbits(np.bitwise_xor(a, b))
    return float(diff.sum()) / diff.size


STEP_ARCHS = ["mixtral-8x22b-smoke", "falcon-mamba-7b-smoke",
              "jamba-1.5-large-398b-smoke"]


def _reference_steps(arch):
    jcfg = jget_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jopt = jinit_state(jcfg, mesh, block=BLOCK)
    steps = {stage: make_train_step(
        jcfg, mesh, TrainStepConfig(optimizer="onebit_adam",
                                    compressor="onebit", block_size=BLOCK,
                                    stage=stage), donate=False)
        for stage in ("warmup", "compressed")}
    stream = JStream(jcfg, JShape("t", 32, 4, "train"), seed=0)
    return jcfg, jparams, jopt, steps, stream


def _routes(cfg, flat, batch, monkeypatch):
    """The top-k expert choices of every MoE layer, in forward order, of
    the port's model over ``flat`` on ``batch``."""
    seen = []
    moe = TT.moe_forward

    def spy(p, x, c, *args, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        seen.append(torch.topk(torch.softmax(logits, -1), c.moe_top_k,
                               -1)[1])
        return moe(p, x, c, *args, **kw)
    with monkeypatch.context() as mp:
        mp.setattr(TT, "moe_forward", spy)
        with torch.no_grad():
            TT.loss_fn(TT.Transformer(cfg, flat.clone()), batch)
    return seen


def _payload_flips(tm_prev, ts, jopt_prev, g):
    """Sign bits of the first compressed payload (worker_err = 0: the
    signs of the local momentum b1*m + (1-b1)*g) that disagree."""
    tm_local = 0.9 * tm_prev + (1.0 - 0.9) * ts.g
    jm_local = 0.9 * jopt_prev.m.reshape(-1) + (1.0 - 0.9) * g
    return _bits_disagree(tpack(tm_local).numpy(),
                          np.asarray(jpack(jm_local)))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_port_steps_match_reference(arch, monkeypatch):
    """3 warmup + 2 compressed 1-bit Adam steps through the port's
    ``train_step`` and the reference's ``make_train_step`` on a 1 x 1
    mesh, from the same parameters and batches, each side on its own.

    A MoE layer routes each token to its top-k experts, a discrete choice:
    once the two parameter vectors have drifted apart (Adam's first
    steps turn rounding differences of near-zero gradients into update
    differences; the compressed update's sign flips are divided by
    sqrt(v)), a token may route differently and move by a whole expert.
    So every step counts the tokens whose choices differ between the two
    sides' parameters, and the losses and aux are held to the slice's
    tolerances up to the first step that routes differently; from there
    the runs are different functions and only stay finite.
    ``test_port_step_from_reference_state`` holds every step from one
    state."""
    jcfg, jparams, jopt, steps, stream = _reference_steps(arch)
    cfg = get_config(arch)
    optimizer = get_optimizer("onebit_adam", compressor="onebit",
                              compressor_kwargs={"block_size": BLOCK})
    ts = init_train_state(cfg, params_from_jax(_np(jparams)), optimizer,
                          BLOCK)
    d_pad = flat_dim(cfg, 1, BLOCK)

    jlosses, tlosses, jaux, taux, disagree = [], [], [], [], []
    for step in range(STEPS):
        stage = "warmup" if step < WARMUP else "compressed"
        batch = stream.batch_at(step)
        tb = _torch_batch(batch)
        lr = lr_schedule(step, BASE_LR, LR_WARMUP)
        jflat = flat_from_params(params_from_jax(_np(jparams)), d_pad)
        disagree.append(sum(
            int((a != b).any(-1).sum()) for a, b in zip(
                _routes(cfg, jflat, tb, monkeypatch),
                _routes(cfg, ts.x, tb, monkeypatch))))
        if step == WARMUP:
            g, _, _, _ = flat_grads(jparams, batch, jcfg, ParallelCtx(),
                                    0.01, 1, d_pad)
            tm_prev, jopt_prev = ts.opt.m.clone(), jopt
        jparams, jopt, jm = steps[stage](jparams, jopt, batch,
                                         jnp.float32(lr))
        tm = train_step(ts, optimizer, tb, lr, stage)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
        jaux.append(float(jm["aux"]))
        taux.append(float(tm["aux"]))
        if step == WARMUP and not any(disagree):
            frac = _payload_flips(tm_prev, ts, jopt_prev, g)
            print(f"{arch}: first compressed payload: {frac:.2e} of the "
                  "sign bits disagree")
            assert frac <= SIGN_FLIP_CEILING, frac
        if step == WARMUP - 1:
            v_frozen, jv_frozen = ts.opt.v.clone(), np.asarray(jopt.v)
        if stage == "compressed":      # v stays frozen on both sides
            assert torch.equal(ts.opt.v, v_frozen)
            np.testing.assert_array_equal(np.asarray(jopt.v), jv_frozen)
    print(arch, "tokens routed differently a step", disagree)
    print(arch, "losses port", tlosses, "reference", jlosses)
    assert all(np.isfinite(tlosses)) and all(np.isfinite(taux))
    same = next((i for i, n in enumerate(disagree) if n), STEPS)
    if not jcfg.n_experts:
        assert disagree == [0] * STEPS and taux == [0.0] * STEPS
    else:
        assert min(taux) > 0
    for lo, hi, rtol in ((0, min(same, WARMUP + 1), LOSS_RTOL_WARMUP),
                         (WARMUP + 1, same, LOSS_RTOL_COMPRESSED)):
        if lo < hi:
            np.testing.assert_allclose(tlosses[lo:hi], jlosses[lo:hi],
                                       rtol=rtol)
            np.testing.assert_allclose(taux[lo:hi], jaux[lo:hi], rtol=rtol,
                                       atol=1e-7)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_port_step_from_reference_state(arch):
    """Each of the 3 warmup + 2 compressed steps from the reference's
    state of that step (parameters and every optimizer slot carried
    across): the loss and aux as ``loss_fn``'s (the same parameters, rtol
    1e-5), a warmup step's new v to the gradient's tolerance (v takes
    (1-b2) g^2), and a compressed step's worker payload at most 1e-3 of
    its sign bits apart (the slice's ceiling, for its reason)."""
    from repro_torch.convert import state_from_global
    from repro_torch.state import flat_layout

    jcfg, jparams, jopt, steps, stream = _reference_steps(arch)
    cfg = get_config(arch)
    optimizer = get_optimizer("onebit_adam", compressor="onebit",
                              compressor_kwargs={"block_size": BLOCK})
    d_pad = flat_dim(cfg, 1, BLOCK)
    for step in range(STEPS):
        stage = "warmup" if step < WARMUP else "compressed"
        batch = stream.batch_at(step)
        lr = lr_schedule(step, BASE_LR, LR_WARMUP)
        ts = init_train_state(cfg, params_from_jax(_np(jparams)),
                              optimizer, BLOCK)
        slots = optimizer.state_slots(ts.layout)
        ts.opt = state_from_global({k: np.asarray(jopt[k]) for k in jopt},
                                   slots, flat_layout(d_pad, 1, ts.segs.n))
        if stage == "compressed":
            g, _, _, _ = flat_grads(jparams, batch, jcfg, ParallelCtx(),
                                    0.01, 1, d_pad)
            tm_prev, jopt_prev = ts.opt.m.clone(), jopt
        jparams, jopt, jm = steps[stage](jparams, jopt, batch,
                                         jnp.float32(lr))
        tm = train_step(ts, optimizer, _torch_batch(batch), lr, stage)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=str(step))
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=str(step))
        if stage == "warmup":
            want = np.asarray(jopt.v).reshape(-1)
            np.testing.assert_allclose(
                ts.opt.v.numpy(), want, rtol=2 * GRAD_RTOL,
                atol=GRAD_ATOL_SHARE * float(np.abs(want).max()),
                err_msg=str(step))
        else:
            frac = _payload_flips(tm_prev, ts, jopt_prev, g)
            assert frac <= SIGN_FLIP_CEILING, (step, frac)


def test_moe_checkpoint_loads_in_reference(tmp_path):
    """A checkpoint of a MoE arch written by the port's launcher loads in
    the reference's loader: every parameter and slot bitwise."""
    from repro.state import layout_manifest as jmanifest
    from repro.train.step import state_layout_ctx
    from repro_torch.convert import state_to_global
    from repro_torch.state import flat_layout, layout_manifest

    arch = "mixtral-8x22b-smoke"
    path = str(tmp_path / "moe.npz")
    res = run(arch=arch, steps=4, warmup_steps=3, batch=4, seq=32,
              block_size=BLOCK, lr=2e-3, lr_warmup=2, device="cpu",
              verbose=False, ckpt=path)
    ts = res["state"]
    params = params_to_jax(params_from_flat(ts.x, TT.leaf_shapes(
        get_config(arch))))
    slots = res["optimizer"].state_slots(res["layout"])
    ctx = flat_layout(ts.x.shape[0], 1, ts.segs.n)
    glob = state_to_global([ts.opt], slots, ctx)

    jcfg = jget_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    jopt_obj = jget_optimizer("onebit_adam", compressor="onebit",
                              compressor_kwargs={"block_size": BLOCK})
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jopt = jinit_state(jcfg, mesh, block=BLOCK, optimizer=jopt_obj)
    jslots = jopt_obj.state_slots("replicated")
    jctx = state_layout_ctx(jcfg, mesh, block=BLOCK)
    assert layout_manifest(slots, ctx, block=BLOCK) == \
        jmanifest(jslots, jctx, block=BLOCK)
    (lp, lst), step = jload(path, jparams, jopt, slots=jslots, ctx=jctx,
                            n_buckets=1, block=BLOCK)
    assert step == 4
    loaded = flatten_with_keys(_np(lp))
    for k, want in flatten_with_keys(params).items():
        np.testing.assert_array_equal(loaded[k], want, err_msg=k)
    for k in glob:
        np.testing.assert_array_equal(np.asarray(lst[k]), glob[k],
                                      err_msg=k)
