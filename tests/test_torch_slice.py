"""Slice 1 end to end: the port's training step against the JAX package.

3 warmup + 2 compressed 1-bit Adam steps of ``bert-large-smoke`` (f32)
through the port's ``train_step`` and through the reference's
``make_train_step`` on a 1x1 mesh, from the same parameters (carried
across as numpy) and the same batches (the reference's stream, as numpy).

Tolerances, and why (measured on the CPU: warmup losses within 4e-6
relative, 4.8e-5 of the payload's sign bits apart, the loss after the
first compressed update 5e-4 relative apart):
  * losses up to step 3 (parameters moved by warmup steps only): rtol
    2e-5.  The forward/backward sums in another order than XLA, and Adam's
    first steps divide the momentum by sqrt(v) ~ |g|, which turns ULP
    differences of the gradient into small update differences.
  * the first compressed step's worker payload: at most 1e-3 of the sign
    bits may disagree.  A bit flips only where the local momentum lies
    within the accumulated rounding difference of zero.
  * the loss after the first compressed update (step 4): rtol 2e-3.  Each
    flipped sign moves its coordinate by 2 * scale / sqrt(v) against the
    reference, and after 3 warmup steps v is small, so a few dozen flips
    move the loss by ~1e-4 of itself.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.core.compression import pack_signs as jpack  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.train.step import (TrainStepConfig, flat_grads,  # noqa: E402
                              init_train_state as jinit_state,
                              make_train_step)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.compression import pack_signs as tpack  # noqa: E402
from repro_torch.launch.train import lr_schedule, run  # noqa: E402
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
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _bits_disagree(a: np.ndarray, b: np.ndarray) -> float:
    diff = np.unpackbits(np.bitwise_xor(a, b))
    return float(diff.sum()) / diff.size


def test_port_steps_match_reference():
    jcfg = jget_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jopt = jinit_state(jcfg, mesh, block=BLOCK)
    steps = {stage: make_train_step(
        jcfg, mesh, TrainStepConfig(optimizer="onebit_adam",
                                    compressor="onebit", block_size=BLOCK,
                                    stage=stage), donate=False)
        for stage in ("warmup", "compressed")}
    stream = JStream(jcfg, InputShape("t", 64, 4, "train"), seed=0)

    cfg = get_config(ARCH)
    optimizer = get_optimizer("onebit_adam", compressor="onebit",
                              compressor_kwargs={"block_size": BLOCK})
    ts = init_train_state(cfg, params_from_jax(jax.tree.map(np.asarray,
                                                            jparams)),
                          optimizer, BLOCK)
    d_pad = flat_dim(cfg, 1, BLOCK)

    jlosses, tlosses = [], []
    for step in range(STEPS):
        stage = "warmup" if step < WARMUP else "compressed"
        batch = stream.batch_at(step)
        lr = lr_schedule(step, BASE_LR, LR_WARMUP)
        if step == WARMUP:
            # the first compressed step's worker payload (worker_err = 0):
            # signs of the local momentum b1*m + (1-b1)*g, on both sides
            g, _, _, _ = flat_grads(jparams, batch, jcfg, ParallelCtx(),
                                    0.01, 1, d_pad)
            jm_local = 0.9 * jopt.m.reshape(-1) + (1.0 - 0.9) * g
            tm_prev = ts.opt.m.clone()
        jparams, jopt, jm = steps[stage](jparams, jopt, batch,
                                         jnp.float32(lr))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tm = train_step(ts, optimizer, tb, lr, stage)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
        if step == WARMUP:
            tm_local = 0.9 * tm_prev + (1.0 - 0.9) * ts.g
            frac = _bits_disagree(tpack(tm_local).numpy(),
                                  np.asarray(jpack(jm_local)))
            print(f"first compressed payload: {frac:.2e} of the sign "
                  "bits disagree")
            assert frac <= SIGN_FLIP_CEILING, frac
        if step == WARMUP - 1:
            v_frozen, jv_frozen = ts.opt.v.clone(), np.asarray(jopt.v)
        if stage == "compressed":      # v stays frozen on both sides
            assert torch.equal(ts.opt.v, v_frozen)
            np.testing.assert_array_equal(np.asarray(jopt.v), jv_frozen)
    assert all(np.isfinite(tlosses))
    print("losses port", tlosses, "reference", jlosses)
    np.testing.assert_allclose(tlosses[:WARMUP + 1], jlosses[:WARMUP + 1],
                               rtol=LOSS_RTOL_WARMUP)
    np.testing.assert_allclose(tlosses[WARMUP + 1:], jlosses[WARMUP + 1:],
                               rtol=LOSS_RTOL_COMPRESSED)


def _run_child(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port and running it on the CPU
    (training under each layout with a checkpoint resume, and the serving
    engine) loads no JAX and nothing of the ``repro`` package."""
    code = (
        "import importlib, os, pkgutil, sys, tempfile\n"
        "import repro_torch, repro_torch.launch.train as L\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "ck = os.path.join(tempfile.mkdtemp(), 'c.npz')\n"
        "for rc in ('onebit_lamb', 'zerone_adam_local'):\n"
        "    L.run(arch='bert-large-smoke', recipe=rc, steps=2,"
        " warmup_steps=1, batch=2, seq=32, block_size=512, device='cpu',"
        " verbose=False, ckpt=ck)\n"
        "    L.run(arch='bert-large-smoke', recipe=rc, steps=3,"
        " warmup_steps=1, batch=2, seq=32, block_size=512, device='cpu',"
        " verbose=False, resume=ck)\n"
        "r = L.run(arch='bert-large-smoke', steps=3, warmup_steps=2,"
        " batch=2, seq=32, block_size=512, device='cpu', verbose=False)\n"
        "assert [h['stage'] for h in r['history']] == "
        "['warmup', 'warmup', 'compressed']\n"
        "assert r['launches'] == {'ef_compress': 0, 'decompress': 0,"
        " 'adam_step': 0, 'flash_attention': 0,"
        " 'flash_attention_wgmma': 0, 'flash_attention_wide': 0,"
        " 'lm_head_xent_fwd': 0, 'lm_head_xent_bwd': 0,"
        " 'moe_permute': 0, 'moe_combine': 0},"
        " r['launches']\n"
        "import dataclasses, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.transformer import init_params\n"
        "from repro_torch.serve import GenerationConfig, ServeEngine\n"
        "cfg = dataclasses.replace(get_config('llama3.2-3b-smoke'),"
        " attn_impl='pallas')\n"
        "eng = ServeEngine(cfg, init_params(cfg,"
        " torch.Generator().manual_seed(0)), device='cpu')\n"
        "g = eng.generate(torch.zeros(2, 16, dtype=torch.int32),"
        " GenerationConfig(max_new_tokens=3))\n"
        "assert tuple(g['tokens'].shape) == (2, 3), g\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run_child(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        run(arch=ARCH, steps=1, batch=2, seq=32, block_size=BLOCK,
            device="cuda")


def test_cli_runs_on_cpu():
    """``python -m repro_torch.launch.train --device cpu`` trains through
    the stage switch."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--steps", "3", "--warmup-steps", "2", "--batch",
         "2", "--seq", "16", "--block-size", str(BLOCK), "--log-every",
         "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3
    assert "[warmup" in lines[1] and "[compressed" in lines[2]
