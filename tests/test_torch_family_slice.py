"""Slice 4 end to end: the optimizer family's training steps against the
JAX package.

3 warmup + 2 compressed steps of ``bert-large-smoke`` (f32) through the
port's ``train_step`` and through the reference's ``make_train_step`` on a
1x1 mesh, from the same parameters (carried across as numpy) and the same
batches (the reference's stream, as numpy), for ``onebit_lamb``
(replicated layout; also with ``accum_steps=2``), ``zerone_adam_local``
(the ``local`` layout, ``sync`` from the optimizer's ``sync_due``) and
``onebit_adam_topk`` (whose loss jumps at step 4 on both sides: after 3
warmup steps ``v`` is small and the kept coordinates carry their
accumulated residual).  The method and tolerances are
``tests/test_torch_slice.py``'s, and why:

  * losses up to step 3 (parameters moved by warmup steps only): rtol
    2e-5 — the forward/backward sums in another order than XLA, and the
    first adaptive steps turn ULP differences of the gradient into small
    update differences (1-bit LAMB's trust ratios are ratios of norms
    summed in another order too);
  * the first compressed step's worker payload (1-bit recipes): at most
    1e-3 of the sign bits may disagree (a bit flips only where the local
    momentum lies within the accumulated rounding difference of zero);
  * the loss after the first compressed update (step 4): rtol 2e-3;
  * 1-bit LAMB's frozen trust ratios: rtol 1e-5 (``tests/test_kernels.py``'s
    f32 rtol; ratios of norms of parameters that agree to ~1e-7 after the
    warmup, summed in another order; measured 1.3e-6 on the CPU).

With ``accum_steps=2`` both sides sum the two microbatch gradients in
order and divide by 2, so the same tolerances hold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_optim_recipe as jrecipe  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.core.compression import pack_signs as jpack  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.train.step import (TrainStepConfig, flat_grads,  # noqa: E402
                              init_train_state as jinit_state,
                              make_train_step)
from repro_torch.configs import get_config, get_optim_recipe  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.compression import pack_signs as tpack  # noqa: E402
from repro_torch.launch.train import lr_schedule  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    flat_dim, init_train_state, train_step)

ARCH = "bert-large-smoke"
BLOCK = 512
WARMUP, STEPS = 3, 5
BASE_LR, LR_WARMUP = 2e-3, 2
LOSS_RTOL_WARMUP = 2e-5
LOSS_RTOL_COMPRESSED = 2e-3
SIGN_FLIP_CEILING = 1e-3
SCALE_RTOL = 1e-5
LAYOUT = {"onebit_lamb": "replicated", "zerone_adam_local": "local",
          "onebit_adam_topk": "replicated"}


def _bits_disagree(a: np.ndarray, b: np.ndarray) -> float:
    diff = np.unpackbits(np.bitwise_xor(a, b))
    return float(diff.sum()) / diff.size


@pytest.mark.parametrize("recipe,accum", [("onebit_lamb", 1),
                                          ("onebit_lamb", 2),
                                          ("zerone_adam_local", 1),
                                          ("onebit_adam_topk", 1)])
def test_family_steps_match_reference(recipe, accum):
    layout = LAYOUT[recipe]
    jspec, tspec = jrecipe(recipe), get_optim_recipe(recipe)
    assert jspec.optimizer_kwargs == tspec.optimizer_kwargs
    jcfg = jget_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    tsc = TrainStepConfig(optimizer=jspec.optimizer,
                          compressor=jspec.compressor,
                          block_size=BLOCK, layout=layout,
                          opt_kwargs=jspec.optimizer_kwargs,
                          accum_steps=accum)
    jsteps = {stage: make_train_step(
        jcfg, mesh, dataclasses.replace(tsc, stage=stage), donate=False)
        for stage in ("warmup", "compressed")}
    jopt = jinit_state(jcfg, mesh, block=BLOCK, layout=layout,
                       optimizer=jsteps["warmup"].optimizer)
    stream = JStream(jcfg, InputShape("t", 64, 4, "train"), seed=0)

    cfg = get_config(ARCH)
    optimizer = get_optimizer(tspec.optimizer, compressor=tspec.compressor,
                              compressor_kwargs={"block_size": BLOCK},
                              **(tspec.optimizer_kwargs or {}))
    ts = init_train_state(cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams)),
                          optimizer, BLOCK, layout=layout)
    d_pad = flat_dim(cfg, 1, BLOCK)
    assert ts.segs.n == jopt.scale.size

    jlosses, tlosses = [], []
    for step in range(STEPS):
        stage = "warmup" if step < WARMUP else "compressed"
        sync = stage == "warmup" or optimizer.sync_due(step - WARMUP)
        assert sync          # zerone_adam_local doubles after 64 steps
        batch = stream.batch_at(step)
        lr = lr_schedule(step, BASE_LR, LR_WARMUP)
        if step == WARMUP and tspec.compressor == "onebit":
            g, _, _, _ = flat_grads(jparams, batch, jcfg, ParallelCtx(),
                                    0.01, accum, d_pad)
            jm_local = 0.9 * jopt.m.reshape(-1) + (1.0 - 0.9) * g
            tm_prev = ts.opt.m.clone()
        jparams, jopt, jm = jsteps[stage](jparams, jopt, batch,
                                          jnp.float32(lr))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tm = train_step(ts, optimizer, tb, lr, stage, sync=sync,
                        accum_steps=accum)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
        if step == WARMUP and tspec.compressor == "onebit":
            tm_local = 0.9 * tm_prev + (1.0 - 0.9) * ts.g
            frac = _bits_disagree(tpack(tm_local).numpy(),
                                  np.asarray(jpack(jm_local)))
            assert frac <= SIGN_FLIP_CEILING, frac
        if stage == "compressed" and recipe == "onebit_lamb":
            # the trust ratios froze at the first compressed step
            np.testing.assert_allclose(ts.opt.scale.numpy(),
                                       np.asarray(jopt.scale).reshape(-1),
                                       rtol=SCALE_RTOL)
    assert all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses[:WARMUP + 1], jlosses[:WARMUP + 1],
                               rtol=LOSS_RTOL_WARMUP)
    np.testing.assert_allclose(tlosses[WARMUP + 1:], jlosses[WARMUP + 1:],
                               rtol=LOSS_RTOL_COMPRESSED)


ACCUM_ORDER_RTOL = 2e-5
ACCUM_WEIGHT_RTOL = 1e-3


@pytest.mark.parametrize("mask", ["ones", "mlm"])
def test_accum_steps_against_full_batch(mask):
    """``accum_steps=2`` against one full-batch step, port only, 3 warmup
    steps of ``bert-large-smoke`` at batch 16 x seq 128 (chip_smoke.py's
    accumulation run compares its warmup losses with the full-batch main
    run's at ACCUM_WEIGHT_RTOL).

    With every position in the loss (``ones``) the mean of the two
    microbatch means is the full-batch mean, so only the order of the
    gradient sum differs: rtol 2e-5, the warmup tolerance above.  With the
    stream's MLM mask each microbatch mean weights its own masked tokens,
    so the losses also differ by the mask counts of the halves: measured
    up to 3.6e-4 relative on the CPU, held to 1e-3."""
    from repro_torch.configs.base import InputShape as TShape
    from repro_torch.data import SyntheticStream
    from repro_torch.models.transformer import init_params
    cfg = get_config(ARCH)
    stream = SyntheticStream(cfg, TShape("t", 128, 16, "train"), seed=0)
    losses = {}
    for a in (1, 2):
        opt = get_optimizer("onebit_adam", compressor="onebit",
                            compressor_kwargs={"block_size": BLOCK})
        ts = init_train_state(cfg, init_params(
            cfg, torch.Generator().manual_seed(0)), opt, BLOCK)
        out = []
        for step in range(WARMUP):
            batch = stream.batch_at(step)
            if mask == "ones":
                batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
            out.append(float(train_step(ts, opt, batch,
                                        lr_schedule(step, 1e-3, 20),
                                        "warmup", accum_steps=a)["loss"]))
        losses[a] = out
    np.testing.assert_allclose(
        losses[2], losses[1],
        rtol=ACCUM_ORDER_RTOL if mask == "ones" else ACCUM_WEIGHT_RTOL)
