"""The rest of serving against the JAX package on the CPU: every decoding
family's prefill and KV / SSM-cached decode (MoE under both dispatches,
the Mamba-1 SSM, the Jamba hybrid, the VLM prefix, the audio stub's
frames), the chunked online-softmax prefill, the SSM's decode state, the
engine's greedy generation, ``make_serve_step`` on one rank and over gloo
(batch-sharded, and seq-sharded flash-decoding), the cache tree and the
config helpers.

Parameters come from the reference's ``init_params`` through
``convert.params_from_jax``; prompts, frames and patches are numpy arrays
from a seed.  Every ``reduced()`` config computes in f32, and logits and
cache leaves agree to rtol/atol 1e-4 (``tests/test_torch_serve.py``'s
``TOL``: f32 sums in another order than XLA's); the seq-sharded decode at
2e-4, the tolerance of the reference's own seq-sharded test
(``tests/test_distributed.py``).  A MoE token whose top-k choices differ
between the two packages (a near-tie summed in another order) moves a
whole expert, so the MoE layers' choices are recorded on both sides, the
rerouted tokens counted at each step, and the tolerance held up to the
first step where one reroutes (never the prefill).  The multi-rank tests
spawn their ranks (``_torch_serve_worker``) with a ``file://``
rendezvous under ``tmp_path`` and one torch thread a rank; the reference
runs in this process.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

import _torch_serve_worker as worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.serve import GenerationConfig as JGenerationConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train.step import make_serve_step as jmake_serve_step  # noqa: E402,E501
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, InputShape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import DpMesh  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import GenerationConfig, ServeEngine  # noqa: E402
from repro_torch.train.step import make_serve_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's decoding archs (the port's MLA archs do not serve yet)
REF_ARCHS = [a for a in list_archs() if a in jlist_archs()]
DECODING = [a for a in REF_ARCHS if get_config(a).family != "encoder"]
# every decoding arch, and the MoE one under the gather dispatch
CASES = DECODING + ["mixtral-8x22b-gather"]
B, S, STEPS = 2, 72, 4         # S passes mixtral-smoke's window of 64
ONE_RANK = DpMesh(axes=("dp",), sizes=(1,), groups={})


def _cfgs(case: str, **kw):
    """(reference config, port config) of ``case``'s reduced() config."""
    arch, gather = (case[:-len("-gather")], True) \
        if case.endswith("-gather") else (case, False)
    if gather:
        kw["moe_dispatch"] = "gather"
    return (dataclasses.replace(jget_config(arch + "-smoke"), **kw),
            dataclasses.replace(get_config(arch + "-smoke"), **kw))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    """The reference's parameters of ``arch``'s reduced() config (seed 0)
    and the port's copy."""
    jparams = JT.init_params(jget_config(arch + "-smoke"),
                             jax.random.PRNGKey(0), tp=1)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _inputs(cfg, seed: int, b: int, s: int, n: int):
    """Prefill inputs of ``s`` positions and ``n`` one-position decode
    inputs, numpy from ``seed``: tokens, or frames for the audio stub;
    the VLM's prefill also takes its patch prefix."""
    rng = np.random.default_rng(seed)
    if cfg.embed_kind == "embeddings":
        x = rng.standard_normal((b, s + n, cfg.d_model)).astype(np.float32)
        pre, key = {"embeddings": x[:, :s]}, "embeddings"
    else:
        x = rng.integers(0, cfg.vocab, (b, s + n)).astype(np.int32)
        pre, key = {"tokens": x[:, :s]}, "tokens"
    if cfg.embed_kind == "prefix":
        pre["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return pre, [{key: x[:, s + i:s + i + 1]} for i in range(n)]


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_caches(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for leaf, w in want[name].items():
            g = got[name][leaf]
            assert tuple(g.shape) == w.shape, (name, leaf)
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                       err_msg=f"{name}.{leaf}", **tol)


def _spy_routes(monkeypatch):
    """Record the top-k expert choices of every MoE call, in call order,
    of the port (``transformer.moe_forward``) and of the reference
    (``repro.models.mlp.moe_forward``, through an ordered debug
    callback, so inside its scans too)."""
    port, ref = [], []
    tmoe, jmoe = TT.moe_forward, JM.moe_forward

    def tspy(p, x, cfg, *a, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
        port.append(torch.topk(torch.softmax(logits, -1), cfg.moe_top_k,
                               -1)[1].numpy())
        return tmoe(p, x, cfg, *a, **kw)

    def jspy(p, x, cfg, ctx, *a, **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"].astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe_top_k)
        jax.debug.callback(lambda i: ref.append(np.asarray(i)), idx,
                           ordered=True)
        return jmoe(p, x, cfg, ctx, *a, **kw)
    monkeypatch.setattr(TT, "moe_forward", tspy)
    monkeypatch.setattr(JM, "moe_forward", jspy)

    def rerouted(n_calls: int) -> int:
        """Tokens routed differently since the last call, over the
        ``n_calls`` MoE calls each side made since."""
        jax.effects_barrier()
        assert len(port) == len(ref) == n_calls
        n = sum(int((a != b).any(-1).sum()) for a, b in zip(port, ref))
        port.clear()
        ref.clear()
        return n
    return rerouted


# --------------------------------------------------------------------------
# prefill and decode, every decoding arch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_reference(case, monkeypatch):
    """Prefill logits and every cache leaf, then STEPS teacher-forced
    decode steps (logits and caches), against the reference; mixtral's
    prompt passes its window, so the prefill seeds the ring buffer."""
    jcfg, cfg = _cfgs(case)
    jparams, tparams = _params(case.removesuffix("-gather"))
    pre, steps = _inputs(cfg, 1, B, S, STEPS)
    n_pre = cfg.n_prefix if cfg.embed_kind == "prefix" else 0
    cache_len = n_pre + S + STEPS
    rerouted = _spy_routes(monkeypatch)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    counts = []

    def check(logits, jlogits, caches, jcaches):
        counts.append(rerouted(n_moe))
        if any(counts):        # held up to the first rerouted token
            return
        assert tuple(logits.shape) == jlogits.shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _assert_caches(caches, jcaches)

    jlogits, jcaches = JT.prefill(jparams, _j(pre), jcfg, ParallelCtx(),
                                  cache_len=cache_len)
    with torch.no_grad():
        logits, caches = TT.prefill(tparams, _t(pre), cfg,
                                    cache_len=cache_len)
    check(logits, jlogits, caches, jcaches)
    jdecode = jax.jit(lambda p, b, c, pos: JT.decode_step(
        p, b, c, pos, jcfg, ParallelCtx()))
    for i, step in enumerate(steps):
        pos = n_pre + S + i
        jlogits, jcaches = jdecode(jparams, _j(step), jcaches, jnp.int32(pos))
        with torch.no_grad():
            logits, caches = TT.decode_step(tparams, _t(step), caches, pos,
                                            cfg)
        check(logits, jlogits, caches, jcaches)
    print(case, "tokens rerouted: prefill, then each decode step", counts)
    assert counts[0] == 0


# --------------------------------------------------------------------------
# the chunked online-softmax prefill
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["chunked", "auto"])
@pytest.mark.parametrize("window", [None, 64])
def test_chunked_prefill_matches_reference(impl, window, monkeypatch):
    """S = 320 > 4 * attn_chunk (64): "chunked" and "auto" both take the
    online softmax, once a layer, and the prefill matches the
    reference's."""
    jcfg, cfg = _cfgs("llama3.2-3b", attn_impl=impl, window=window)
    jparams, tparams = _params("llama3.2-3b")
    s = 320
    pre, _ = _inputs(cfg, 2, B, s, 0)
    calls = []
    chunked = TA._sdpa_chunked
    monkeypatch.setattr(TA, "_sdpa_chunked",
                        lambda *a: calls.append(a[-1]) or chunked(*a))
    jlogits, jcaches = JT.prefill(jparams, _j(pre), jcfg, ParallelCtx())
    with torch.no_grad():
        logits, caches = TT.prefill(tparams, _t(pre), cfg)
    assert calls == [cfg.attn_chunk] * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_caches(caches, jcaches)


@pytest.mark.parametrize("window", [None, 40])
def test_sdpa_chunked_matches_reference(window):
    """The online softmax alone, with a query offset (the queries are the
    last 32 of 128 positions) and chunks of 32."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((2, 32, 4, 16), (2, 128, 4, 16), (2, 128, 4, 16)))
    want = JA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            96, window, 32)
    got = TA._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 96, window, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the SSM's decode state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, None])
def test_ssm_state_and_decode_match_reference(chunk, monkeypatch):
    """``ssm_forward(return_state=True)`` (the scan 16 timesteps at a time,
    the last chunk short, or at its default, one chunk here) and three
    ``decode_ssm`` steps from its state, against the reference."""
    jcfg, cfg = _cfgs("falcon-mamba-7b")
    if chunk:
        monkeypatch.setattr(TS, "SCAN_CHUNK", chunk)
    jp = JS.init_ssm(jax.random.PRNGKey(4), jcfg, 1)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 40, cfg.d_model)).astype(np.float32)
    jout, jst = JS.ssm_forward(jp, jnp.asarray(x), jcfg, ParallelCtx(),
                               return_state=True)
    with torch.no_grad():
        out, st = TS.ssm_forward(tp, torch.from_numpy(x), cfg,
                                 return_state=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        assert st["h"].dtype == torch.float32
        _assert_caches({"l": st}, {"l": jst})
        for i in range(3):
            xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
            jy, jst = JS.decode_ssm(jp, jnp.asarray(xt), jst, jcfg,
                                    ParallelCtx())
            y = TS.decode_ssm(tp, torch.from_numpy(xt), st, cfg)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            _assert_caches({"l": st}, {"l": jst})


def test_ssm_prefill_shorter_than_the_conv_tail_raises():
    _, cfg = _cfgs("falcon-mamba-7b")
    _, tparams = _params("falcon-mamba-7b")
    toks = torch.zeros(1, cfg.ssm_conv - 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="conv tail"):
        TT.prefill(tparams, {"tokens": toks}, cfg)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internvl2-2b", "falcon-mamba-7b",
                                  "mixtral-8x22b"])
def test_greedy_generate_matches_reference(arch):
    jparams, tparams = _params(arch)
    cfg = get_config(arch + "-smoke")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(
        np.float32) if cfg.embed_kind == "prefix" else None
    want = JServeEngine(jget_config(arch + "-smoke"), jparams).generate(
        jnp.asarray(prompts), JGenerationConfig(max_new_tokens=8),
        prefix_embeds=None if patches is None else jnp.asarray(patches))
    got = ServeEngine(cfg, tparams, device="cpu").generate(
        torch.from_numpy(prompts), GenerationConfig(max_new_tokens=8),
        prefix_embeds=None if patches is None else torch.from_numpy(patches))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["n_valid"].numpy(),
                                  np.asarray(want["n_valid"]))


def test_engine_keeps_the_f32_leaves_f32():
    """Under a bf16 compute dtype the engine casts the weights once but
    keeps the leaves the reference reads uncast in f32: the norms, the
    router, and the SSM's A_log, D and dt_bias (jamba has them all)."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b-smoke"),
                              compute_dtype="bfloat16")
    _, tparams = _params("jamba-1.5-large-398b")
    eng = ServeEngine(cfg, tparams, device="cpu")
    kept = {p.rsplit(".", 1)[-1] for p, t in eng.params.items()
            if t.dtype == torch.float32}
    assert kept == {"norm1", "norm2", "norm_f", "router", "A_log", "D",
                    "dt_bias"}
    assert eng.params["w_out"].dtype == torch.bfloat16
    out = eng.generate(torch.zeros(1, 8, dtype=torch.int32),
                       GenerationConfig(max_new_tokens=3))
    assert tuple(out["tokens"].shape) == (1, 3)


def test_generate_needs_the_vlm_prefix():
    cfg = get_config("internvl2-2b-smoke")
    eng = ServeEngine(cfg, _params("internvl2-2b")[1], device="cpu")
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.generate(torch.zeros(1, 8, dtype=torch.int32),
                     GenerationConfig(max_new_tokens=2))


# --------------------------------------------------------------------------
# make_serve_step on one rank
# --------------------------------------------------------------------------

def test_serve_step_prefill_one_rank():
    """tests/test_system.py's prefill step at 1 x 1, against the
    reference's step on the same batch."""
    arch = "llama3.2-3b"
    jparams, tparams = _params(arch)
    shape = InputShape("p", 64, 2, "prefill")
    pre, _ = _inputs(get_config(arch + "-smoke"), 6, 2, 64, 0)
    want = jmake_serve_step(jget_config(arch + "-smoke"),
                            make_mesh((1, 1), ("data", "model")),
                            JShape("p", 64, 2, "prefill"))(jparams, _j(pre))
    step = make_serve_step(get_config(arch + "-smoke"), ONE_RANK, shape,
                           device="cpu")
    logits = step(tparams, _t(pre))
    assert tuple(logits.shape) == (
        2, get_config(arch + "-smoke").padded_vocab(1))
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_serve_step_decode_one_rank():
    """tests/test_system.py's decode step at 1 x 1 on falcon-mamba: the
    SSM state moves, and the logits are the reference step's."""
    arch = "falcon-mamba-7b"
    jparams, tparams = _params(arch)
    jcfg, cfg = _cfgs(arch)
    jstep = jmake_serve_step(jcfg, make_mesh((1, 1), ("data", "model")),
                             JShape("d", 64, 2, "decode"))
    step = make_serve_step(cfg, ONE_RANK, InputShape("d", 64, 2, "decode"),
                           device="cpu")
    assert not step.seq_sharded
    caches = step.init_caches(dtype=torch.float32)
    jcaches = jstep.init_caches(dtype=jnp.float32)
    h0 = caches["l0"]["h"].clone()
    batch = {"tokens": np.zeros((2, 1), np.int32)}
    want, _ = jstep(jparams, _j(batch), jcaches, jnp.int32(0))
    logits, caches = step(tparams, _t(batch), caches, 0)
    assert tuple(logits.shape) == (2, cfg.padded_vocab(1))
    assert not torch.equal(caches["l0"]["h"], h0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# make_serve_step over gloo ranks
# --------------------------------------------------------------------------

def _spawn(workdir, world: int, case: dict, params, tokens) -> list:
    worker.write_case(workdir, case, params, tokens)
    mp.start_processes(worker.decode_main,
                       args=(world, str(workdir), "gloo"), nprocs=world,
                       start_method="spawn")
    return [np.load(os.path.join(workdir, f"decode_gloo{r}.npz"))
            for r in range(world)]


def _one_rank(cfg, tparams, case: dict, tokens) -> list:
    step = make_serve_step(cfg, ONE_RANK, InputShape(
        "d", case["seq"], case["batch"], "decode"), device="cpu")
    caches = step.init_caches(dtype=torch.float32)
    out = []
    for i, pos in enumerate(case["positions"]):
        logits, caches = step(tparams, {"tokens": torch.from_numpy(
            tokens[:, i:i + 1])}, caches, pos)
        out.append(logits.numpy())
    return out


def test_batch_sharded_decode_over_two_ranks(tmp_path):
    """A batch of 4 over 2 gloo ranks: each rank decodes its 2 rows
    against its half of the caches; the rows stacked give one rank's
    logits."""
    arch = "jamba-1.5-large-398b"
    _, cfg = _cfgs(arch)
    _, tparams = _params(arch)
    case = dict(arch=arch + "-smoke", dtype="float32", batch=4, seq=32,
                positions=list(range(4)))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (4, 4)).astype(
        np.int32)
    ranks = _spawn(tmp_path / "b2", 2, case, tparams, tokens)
    want = _one_rank(cfg, tparams, case, tokens)
    assert not any(bool(r["seq_sharded"]) for r in ranks)
    for i in range(len(case["positions"])):
        got = np.concatenate([r[f"s{i}"] for r in ranks])
        np.testing.assert_allclose(got, want[i], **TOL)


def test_seq_sharded_decode_over_four_ranks(tmp_path):
    """jamba-smoke in f32, B 1, S 64 over 4 gloo ranks (16 slots each): the
    full-attention caches split along the sequence and combined by the
    all-reduce MAX / SUM, the SSM states replicated.  Steps at positions
    0-4 (as the reference's test; only shard 0 holds keys) and 14-17 (the
    owner moves to shard 1) equal one rank's and the reference's
    unsharded decode at 2e-4."""
    arch = "jamba-1.5-large-398b"
    jcfg, cfg = _cfgs(arch)
    jparams, tparams = _params(arch)
    case = dict(arch=arch + "-smoke", dtype="float32", batch=1, seq=64,
                positions=[0, 1, 2, 3, 4, 14, 15, 16, 17])
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (1, len(case["positions"]))).astype(np.int32)
    ranks = _spawn(tmp_path / "s4", 4, case, tparams, tokens)
    one = _one_rank(cfg, tparams, case, tokens)
    jcaches = JT.init_caches(jcfg, 1, 64, tp=1, dtype=jnp.float32)
    jdecode = jax.jit(lambda p, b, c, pos: JT.decode_step(
        p, b, c, pos, jcfg, ParallelCtx()))
    assert all(bool(r["seq_sharded"]) for r in ranks)
    for i, pos in enumerate(case["positions"]):
        want, jcaches = jdecode(jparams, {"tokens": jnp.asarray(
            tokens[:, i:i + 1])}, jcaches, jnp.int32(pos))
        for r in ranks:
            np.testing.assert_allclose(r[f"s{i}"], one[i], **SEQ_TOL)
            np.testing.assert_allclose(r[f"s{i}"], np.asarray(want),
                                       **SEQ_TOL)


# --------------------------------------------------------------------------
# the cache tree and the configs
# --------------------------------------------------------------------------

def _split_dim(spec: PartitionSpec):
    """The dim of a reference cache spec that the dp axes split."""
    dims = [i for i, a in enumerate(spec) if a not in (None, "model")]
    assert len(dims) <= 1
    return dims[0] if dims else None


@pytest.mark.parametrize("arch", DECODING)
def test_cache_tree_matches_reference(arch):
    """``init_caches`` (one shard and 4 sequence shards: shapes, dtypes,
    zeros) and ``cache_specs`` (batch- and seq-sharded) against the
    reference's, leaf by leaf."""
    jcfg, cfg = _cfgs(arch)
    for shards in (1, 4):
        want = JT.init_caches(jcfg, 3, 50, tp=1, seq_shards=shards)
        got = TT.init_caches(cfg, 3, 50, seq_shards=shards)
        for name in want:
            for leaf, w in want[name].items():
                g = got[name][leaf]
                assert tuple(g.shape) == w.shape, (shards, name, leaf)
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
                assert not g.any()
        assert sorted(got) == sorted(want)
    for seq_sharded in (False, True):
        want = JT.cache_specs(jcfg, "model", ("data",), seq_sharded)
        got = TT.cache_specs(cfg, seq_sharded)
        assert {n: {k: _split_dim(s) for k, s in leaves.items()}
                for n, leaves in want.items()} == \
            {n: {k: dims[0] for k, dims in leaves.items()}
             for n, leaves in got.items()}


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_supports_long_decode_matches_reference(arch):
    assert get_config(arch).supports_long_decode == \
        jget_config(arch).supports_long_decode


def test_shapes_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "musicgen-large"])
def test_serve_decode_example_runs(arch):
    """The port of examples/serve_decode.py on the CPU: token prompts, and
    the audio stub's frames through decode_step."""
    from repro_torch.examples import serve_decode
    out = serve_decode.main(arch, prompt_len=8, new_tokens=3, device="cpu")
    assert tuple(out.shape) == (2, 4)
    assert bool(((out >= 0) & (out < get_config(arch).vocab)).all())
