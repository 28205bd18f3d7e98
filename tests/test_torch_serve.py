"""The serving slice: the port's prefill, decode and engine against the
JAX package, on ``llama3.2-3b-smoke`` (2 layers, d 256, 4 q / 2 kv heads,
SwiGLU, f32).

Parameters come from the reference's ``init_params`` and are carried
across by ``convert.params_from_jax``; token prompts are numpy arrays
from a seed.  Prefill logits and caches (with ``attn_impl="pallas"``,
the reference's Pallas kernel in interpret mode against the port's plain
version, and with ``"full"``), and four teacher-forced decode steps
(logits and updated caches), agree to rtol/atol 1e-4, the tolerance of
``tests/test_kernels.py``'s prefill test: the f32 sums run in another
order than XLA's.  Greedy generation gives the reference's tokens.
Sampling draws from other generators on the two sides, so only its
structure is compared: after a sequence's eos every token is eos, and
``n_valid`` counts the tokens before it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.serve import GenerationConfig as JGenerationConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402

ARCH = "llama3.2-3b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jparams = JT.init_params(jget_config(ARCH), jax.random.PRNGKey(0), tp=1)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _prompts(seed, b, s):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s),
                                                dtype=np.int32)


def _cfgs(impl):
    return (dataclasses.replace(jget_config(ARCH), attn_impl=impl),
            dataclasses.replace(get_config(ARCH), attn_impl=impl))


def _assert_caches(got, want):
    for name in ("k", "v"):
        np.testing.assert_allclose(got["l0"][name].numpy(),
                                   np.asarray(want["l0"][name]), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "full"])
def test_prefill_matches_reference(params, impl):
    jparams, tparams = params
    jcfg, cfg = _cfgs(impl)
    toks = _prompts(1, 2, 64)
    jlogits, jcaches = JT.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  jcfg, ParallelCtx(), cache_len=72)
    with torch.no_grad():
        logits, caches = TT.prefill(tparams,
                                    {"tokens": torch.from_numpy(toks)}, cfg,
                                    cache_len=72)
    assert tuple(logits.shape) == jlogits.shape == (2, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert tuple(caches["l0"]["k"].shape) == (2, 2, 72, 2, 64)
    _assert_caches(caches, jcaches)


def test_teacher_forced_decode_matches_reference(params):
    jparams, tparams = params
    jcfg, cfg = _cfgs("pallas")
    s, n_steps = 32, 4
    toks = _prompts(2, 2, s + n_steps)
    jlogits, jcaches = JT.prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :s])}, jcfg, ParallelCtx(),
        cache_len=s + n_steps)
    jdecode = jax.jit(lambda p, b, c, pos: JT.decode_step(
        p, b, c, pos, jcfg, ParallelCtx()))
    with torch.no_grad():
        _, caches = TT.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :s])},
                               cfg, cache_len=s + n_steps)
        for i in range(n_steps):
            step = toks[:, s + i:s + i + 1]
            jlogits, jcaches = jdecode(jparams, {"tokens": jnp.asarray(step)},
                                       jcaches, jnp.int32(s + i))
            logits, caches = TT.decode_step(
                tparams, {"tokens": torch.from_numpy(step)}, caches, s + i,
                cfg)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            _assert_caches(caches, jcaches)


def test_greedy_generate_matches_reference(params):
    jparams, tparams = params
    prompts = _prompts(3, 2, 16)
    want = JServeEngine(jget_config(ARCH), jparams).generate(
        jnp.asarray(prompts), JGenerationConfig(max_new_tokens=8))
    got = ServeEngine(get_config(ARCH), tparams, device="cpu").generate(
        torch.from_numpy(prompts), GenerationConfig(max_new_tokens=8))
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["n_valid"].numpy(),
                                  np.asarray(want["n_valid"]))
    assert len(got["decode_ms"]) == 7 and got["prefill_ms"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_generate_stops_at_eos(params, seed):
    _, tparams = params
    gc = GenerationConfig(max_new_tokens=12, temperature=1.0, top_k=4,
                          eos_id=7)
    # eos is made likely by raising its output column
    tparams_eos = dict(tparams)
    w_out = tparams["w_out"].clone()
    w_out[:, 7] += 0.5 * w_out.abs().max()
    tparams_eos["w_out"] = w_out
    eng = ServeEngine(get_config(ARCH), tparams_eos, device="cpu")
    out = eng.generate(torch.from_numpy(_prompts(4, 4, 16)), gc,
                       generator=torch.Generator().manual_seed(seed))
    toks, nv = out["tokens"].numpy(), out["n_valid"].numpy()
    assert toks.shape == (4, 12) and (toks < 512).all()
    for row, n in zip(toks, nv):
        # n_valid = tokens before the first eos; every later token is eos
        first = np.flatnonzero(row == 7)
        assert n == (first[0] if first.size else 12)
        assert (row[n:] == 7).all()
    assert (nv < 12).any()


def test_engine_refuses_missing_card_and_encoders(params):
    _, tparams = params
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(get_config(ARCH), tparams, device="cuda")
    with pytest.raises(ValueError, match="encoder"):
        ServeEngine(get_config("bert-large-smoke"), tparams, device="cpu")


def test_cpu_generate_launches_no_kernel(params):
    _, tparams = params
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="pallas")
    build.reset_launch_counts()
    ServeEngine(cfg, tparams, device="cpu").generate(
        torch.from_numpy(_prompts(5, 1, 16)),
        GenerationConfig(max_new_tokens=2))
    assert build.launch_counts() == {"ef_compress": 0, "decompress": 0,
                                     "adam_step": 0, "flash_attention": 0,
                                     "flash_attention_wgmma": 0,
                                     "flash_attention_wide": 0,
                                     "lm_head_xent_fwd": 0,
                                     "lm_head_xent_bwd": 0}


@pytest.mark.parametrize("impl", ["pallas", "full"])
def test_windowed_prefill_and_decode_match_reference(params, impl):
    """A sliding window of 16 under a 32-token prompt: the prefill seeds a
    ring buffer of the window and decode writes slot pos % 16, as the
    reference does."""
    jparams, tparams = params
    jcfg, cfg = (dataclasses.replace(c, window=16) for c in _cfgs(impl))
    s, n_steps = 32, 3
    toks = _prompts(6, 2, s + n_steps)
    jlogits, jcaches = JT.prefill(
        jparams, {"tokens": jnp.asarray(toks[:, :s])}, jcfg, ParallelCtx(),
        cache_len=s + n_steps)
    with torch.no_grad():
        logits, caches = TT.prefill(tparams,
                                    {"tokens": torch.from_numpy(toks[:, :s])},
                                    cfg, cache_len=s + n_steps)
        assert caches["l0"]["k"].shape[2] == 16
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _assert_caches(caches, jcaches)
        for i in range(n_steps):
            step = toks[:, s + i:s + i + 1]
            jlogits, jcaches = JT.decode_step(
                jparams, {"tokens": jnp.asarray(step)}, jcaches,
                jnp.int32(s + i), jcfg, ParallelCtx())
            logits, caches = TT.decode_step(
                tparams, {"tokens": torch.from_numpy(step)}, caches, s + i,
                cfg)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            _assert_caches(caches, jcaches)


@pytest.mark.parametrize("window", [None, 16])
def test_init_caches_match_reference(window):
    jcfg = dataclasses.replace(jget_config(ARCH), window=window)
    cfg = dataclasses.replace(get_config(ARCH), window=window)
    want = JT.init_caches(jcfg, 3, 40, tp=1)
    got = TT.init_caches(cfg, 3, 40)
    for name in ("k", "v"):
        assert tuple(got["l0"][name].shape) == want["l0"][name].shape
        assert got["l0"][name].dtype == torch.bfloat16
        assert not got["l0"][name].any()
