"""The model families of the port (MoE, the Mamba-1 SSM, the Jamba hybrid,
the audio and VLM input stubs) against the JAX reference on the CPU.

Parameters made by ``repro.models.transformer.init_params`` are carried
across as numpy (``repro_torch.convert``); the same numpy batch (the
reference's stream) goes through the reference's ``loss_fn`` under
``jax.value_and_grad`` with ``ParallelCtx()`` and through the port's
module with its backward into the flat gradient.  Every ``reduced()``
config computes in f32, so, as in ``tests/test_torch_model.py``: the loss
agrees to rtol 1e-5, aux to rtol 1e-5 (an atol of 1e-7 for the zero of the
families without experts), acc to atol 1e-6, and the flat gradient to
rtol 1e-4 with an atol of 1e-5 of its largest entry (a sum over the batch
in another order).

A top-k tie (``torch.topk`` and ``jax.lax.top_k`` may break one
differently) would move a token by a whole expert; the MoE tests count
the tokens whose choices disagree and require none.  The optimizer path,
step by step, is ``tests/test_torch_families_steps.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.analysis import model_math as JMM  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.data import make_batch  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.train.step import _flat_dim  # noqa: E402
from repro_torch.analysis import model_math as MM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ArchConfig, InputShape  # noqa: E402
from repro_torch.checkpoint import flatten_with_keys  # noqa: E402
from repro_torch.convert import (flat_from_params,  # noqa: E402
                                 params_from_jax, params_to_jax)
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models import mlp as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import (_grads, flat_dim,  # noqa: E402
                                    init_train_state)

ARCHS = ["bert-base", "bert-large", "deepseek-7b", "falcon-mamba-7b",
         "granite-34b", "internlm2-1.8b", "internvl2-2b",
         "jamba-1.5-large-398b", "llama3.2-3b", "llama4-scout-17b-a16e",
         "mixtral-8x22b", "musicgen-large"]
NEW_ARCHS = ["deepseek-7b", "falcon-mamba-7b", "granite-34b",
             "internvl2-2b", "jamba-1.5-large-398b",
             "llama4-scout-17b-a16e", "mixtral-8x22b", "musicgen-large"]
# fields of the reference's ArchConfig the port does not carry, with the
# value every registered config holds: none (the port carries remat_policy)
REFERENCE_ONLY = {}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_SHARE = 1e-5
BLOCK = 512


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seq(cfg) -> int:
    """A sequence with 16 text tokens after a prefix, else 32."""
    return cfg.n_prefix + 16 if cfg.embed_kind == "prefix" else 32


def _setup(arch, seed, b=2):
    jcfg = jget_config(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed), tp=1)
    batch = make_batch(jcfg, JShape("t", _seq(jcfg), b, "train"),
                       jax.random.PRNGKey(100 + seed))
    return jcfg, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_model(arch, params):
    cfg = get_config(arch)
    flat = flat_from_params(params_from_jax(_np(params)))
    model = TT.Transformer(cfg, flat)
    g = torch.zeros_like(flat)
    model.bind_grads(g)
    return model, g


# --------------------------------------------------------------------------
# configs and layouts
# --------------------------------------------------------------------------

def test_registry_matches_reference():
    assert list_archs() == jlist_archs() == ARCHS


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, size):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if size == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    mine = {f.name for f in dataclasses.fields(ArchConfig)}
    theirs = {f.name for f in dataclasses.fields(jcfg)}
    assert mine <= theirs
    assert {n: getattr(jcfg, n) for n in theirs - mine} == REFERENCE_ONLY
    for name in sorted(mine):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.head_dim, cfg.d_inner, cfg.dt_rank) == \
        (jcfg.head_dim, jcfg.d_inner, jcfg.dt_rank)
    assert [cfg.is_attn_layer(i) for i in range(cfg.n_layers)] == \
        [jcfg.is_attn_layer(i) for i in range(jcfg.n_layers)]
    assert [cfg.is_moe_layer(i) for i in range(cfg.n_layers)] == \
        [jcfg.is_moe_layer(i) for i in range(jcfg.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_counts_match_reference(arch):
    """Leaf paths, shapes and order of ``init_params`` (without
    allocating), the padded flat length, param_count and
    active_param_count at full size."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k, tp=1),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [(".".join(p.key for p in path), tuple(leaf.shape))
            for path, leaf in leaves]
    assert TT.leaf_shapes(cfg) == want
    assert TT.n_superblocks(cfg) == JT.n_superblocks(jcfg)
    assert TT.superblock_layout(cfg) == [tuple(x) for x in
                                         JT._superblock_layout(jcfg)]
    assert cfg.param_count() == jcfg.param_count(1)
    assert cfg.active_param_count() == jcfg.active_param_count(1)
    for n_dp, block in ((1, 4096), (4, 4096)):
        assert flat_dim(cfg, n_dp, block) == _flat_dim(jcfg, 1, n_dp, block)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_convert_carries_every_leaf(arch):
    """The reference's parameters of a reduced arch cross to the port and
    back bitwise, and the port's flat vector is their ravel_pytree."""
    _, params, _ = _setup(arch + "-smoke", 0)
    tparams = params_from_jax(_np(params))
    assert [(p, tuple(t.shape)) for p, t in tparams.items()] == \
        TT.leaf_shapes(get_config(arch + "-smoke"))
    np.testing.assert_array_equal(flat_from_params(tparams).numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    back = flatten_with_keys(params_to_jax(tparams))
    for k, want in flatten_with_keys(_np(params)).items():
        np.testing.assert_array_equal(back[k], want, err_msg=k)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b"])
def test_init_matches_reference_distributions(arch):
    cfg = get_config(arch + "-smoke")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    _, jparams, _ = _setup(arch + "-smoke", 0)
    jleaves = dict(zip((p for p, _ in TT.leaf_shapes(cfg)),
                       jax.tree.leaves(jparams)))
    for path, t in params.items():
        want = np.asarray(jleaves[path])
        assert t.dtype == torch.float32 and tuple(t.shape) == want.shape
        leaf = path.rsplit(".", 1)[-1]
        if leaf in ("A_log", "D") or leaf.startswith("norm"):
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       err_msg=path)
            continue
        np.testing.assert_allclose(float(t.std()), float(want.std()),
                                   rtol=0.1, err_msg=path)
        # two independent draws: their means differ by ~std * sqrt(2/n)
        np.testing.assert_allclose(float(t.mean()), float(want.mean()),
                                   atol=6 * float(want.std())
                                   / math.sqrt(want.size), err_msg=path)
        if leaf == "dt_bias":       # softplus(dt_bias) in [1e-3, 1e-1]
            sp = torch.nn.functional.softplus(t)
            assert float(sp.min()) >= 1e-3 * (1 - 1e-5)
            assert float(sp.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_order_covers_every_parameter(arch):
    cfg = get_config(arch + "-smoke")
    model = TT.Transformer(cfg, torch.zeros(TT.flat_size(cfg)))
    order = model.grad_order()
    assert len(order) == len(list(model.parameters()))
    assert {id(p) for p in order} == {id(p) for p in model.parameters()}
    assert order[0] is model.w_out
    assert order[-1] is (model.embed if model.embed is not None
                         else model.blocks[0].norm1)


# --------------------------------------------------------------------------
# the loss and its gradient, every arch
# --------------------------------------------------------------------------

def _choices_disagree(model, params, batch, jcfg) -> int:
    """Tokens whose top-k expert choices differ between the two packages
    at the first MoE layer (0 where there is none)."""
    i = next((i for i in range(jcfg.n_layers) if jcfg.is_moe_layer(i)),
             None)
    if i is None:
        return 0
    per = len(model.layout)
    router = np.asarray(params["blocks"][f"l{i % per}"]["ffn"]["router"][
        i // per])
    x = np.asarray(JT._inputs_to_h0(params, batch, jcfg, ParallelCtx(),
                                    jnp.float32))
    logits = x.reshape(-1, x.shape[-1]) @ router
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.moe_top_k)
    _, tidx = torch.topk(torch.softmax(torch.from_numpy(logits), -1),
                         jcfg.moe_top_k)
    return int((tidx.numpy() != np.asarray(jidx)).any(-1).sum())


@pytest.mark.parametrize("arch", [a + "-smoke" for a in ARCHS])
def test_loss_and_grads_match_reference(arch):
    jcfg, params, batch = _setup(arch, 0)
    (jtotal, jmet), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, batch, jcfg, ParallelCtx())
    jflat_g, _ = ravel_pytree(jgrads)

    model, gflat = _port_model(arch, params)
    total, met = TT.loss_fn(model, _torch_batch(batch))
    total.backward()
    met = {k: v.detach() for k, v in met.items()}

    assert _choices_disagree(model, params, batch, jcfg) == 0
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    if jcfg.n_experts:
        assert float(met["aux"]) > 0
    else:
        assert float(met["aux"]) == 0.0
    np.testing.assert_allclose(float(met["acc"]), float(jmet["acc"]),
                               atol=1e-6)
    want = np.asarray(jflat_g)
    np.testing.assert_allclose(gflat.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * float(
                                   np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_loss_is_over_text_positions(seed, monkeypatch):
    """The VLM stub's loss reads the final hiddens of the text positions
    only: the head sees (B, S - n_prefix, d), the patches still shape the
    loss through attention, and the loss is the reference's."""
    arch = "internvl2-2b-smoke"
    jcfg, params, batch = _setup(arch, seed)
    seen = []
    xent = TT.vocab_parallel_xent

    def spy(x, *a, **kw):
        seen.append(tuple(x.shape))
        return xent(x, *a, **kw)
    monkeypatch.setattr(TT, "vocab_parallel_xent", spy)
    model, _ = _port_model(arch, params)
    tb = _torch_batch(batch)
    tb["patch_embeds"].requires_grad_(True)
    total, _ = TT.loss_fn(model, tb)
    total.backward()
    n_text = batch["labels"].shape[1]
    assert seen == [(2, n_text, jcfg.d_model)]
    assert n_text == _seq(jcfg) - jcfg.n_prefix
    assert float(tb["patch_embeds"].grad.abs().max()) > 0
    jtotal, _ = JT.loss_fn(params, batch, jcfg, ParallelCtx())
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# the layers alone
# --------------------------------------------------------------------------

def _vjp_both(jfn, tfn, jargs, cot_seed=7):
    """Outputs and input/parameter gradients of both functions under one
    random cotangent of the first output."""
    out, vjp = jax.vjp(jfn, *jargs)
    y = np.asarray(out[0] if isinstance(out, tuple) else out)
    cot = np.random.default_rng(cot_seed).standard_normal(
        y.shape).astype(np.float32)
    jcot = (jnp.asarray(cot), jnp.ones((), jnp.float32)) \
        if isinstance(out, tuple) else jnp.asarray(cot)
    jgrads = vjp(jcot)
    targs = [jax.tree.map(lambda a: torch.from_numpy(
        np.array(a)).requires_grad_(True), a) for a in jargs]
    tout = tfn(*targs)
    ty = tout[0] if isinstance(tout, tuple) else tout
    loss = (ty * torch.from_numpy(cot)).sum()
    if isinstance(tout, tuple):
        loss = loss + tout[1]
    loss.backward()
    tgrads = [jax.tree.map(lambda t: t.grad.numpy(), a) for a in targs]
    return out, tout, jgrads, tgrads


def _close_tree(got, want, rtol=GRAD_RTOL, share=GRAD_ATOL_SHARE):
    fg, _ = ravel_pytree(jax.tree.map(jnp.asarray, got))
    fw, _ = ravel_pytree(want)
    fw = np.asarray(fw)
    np.testing.assert_allclose(np.asarray(fg), fw, rtol=rtol,
                               atol=share * float(np.abs(fw).max()))


def _moe_cfgs(dispatch, cf):
    kw = dict(moe_dispatch=dispatch, capacity_factor=cf)
    return (dataclasses.replace(jget_config("mixtral-8x22b-smoke"), **kw),
            dataclasses.replace(get_config("mixtral-8x22b-smoke"), **kw))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_forward_matches_reference(dispatch, capacity_factor):
    """y, aux and the gradients of x and every leaf, at a capacity that
    keeps every choice and at one that drops some."""
    jcfg, cfg = _moe_cfgs(dispatch, capacity_factor)
    key = jax.random.PRNGKey(3)
    p = JM.init_moe(key, jcfg, 1)
    x = jax.random.normal(jax.random.fold_in(key, 1), (2, 32, jcfg.d_model))
    out, tout, jg, tg = _vjp_both(
        lambda p_, x_: JM.moe_forward(p_, x_, jcfg, ParallelCtx()),
        lambda p_, x_: TM.moe_forward(p_, x_, cfg), (p, x))
    # the routing is the reference's: same top-k, same kept choices
    t = 64
    logits = np.asarray(x).reshape(t, -1) @ np.asarray(p["router"])
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.moe_top_k)
    _, tidx = torch.topk(torch.softmax(torch.from_numpy(logits), -1),
                         jcfg.moe_top_k)
    assert int((tidx.numpy() != np.asarray(jidx)).any(-1).sum()) == 0
    cap = TM.moe_capacity(cfg, t)
    assert cap == max(math.ceil(t * 2 / 4 * capacity_factor), 4)
    counts = np.bincount(np.asarray(jidx).reshape(-1), minlength=4)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert (dropped > 0) == (capacity_factor < 1), (counts, cap)
    np.testing.assert_allclose(tout[0].detach().numpy(), np.asarray(out[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tout[1]), float(out[1]), rtol=1e-6)
    _close_tree(tg[0], jg[0])
    _close_tree(tg[1], jg[1])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_dispatches_agree(capacity_factor):
    """The one-hot dispatch moves each token exactly, so both dispatches
    give the same layer up to the order of the f32 sums."""
    torch.manual_seed(0)
    _, ce = _moe_cfgs("einsum", capacity_factor)
    _, cg = _moe_cfgs("gather", capacity_factor)
    p = {k: torch.from_numpy(np.array(v)) for k, v in JM.init_moe(
        jax.random.PRNGKey(5), jget_config("mixtral-8x22b-smoke"),
        1).items()}
    x = torch.randn(2, 32, ce.d_model)
    ye, ae = TM.moe_forward(p, x, ce)
    yg, ag = TM.moe_forward(p, x, cg)
    torch.testing.assert_close(yg, ye, rtol=1e-5, atol=1e-6)
    assert float(ae) == float(ag)


@pytest.mark.parametrize("seq", [1, 17])
def test_ssm_forward_matches_reference(seq):
    jcfg = jget_config("falcon-mamba-7b-smoke")
    cfg = get_config("falcon-mamba-7b-smoke")
    key = jax.random.PRNGKey(11)
    p = JS.init_ssm(key, jcfg, 1)
    x = jax.random.normal(jax.random.fold_in(key, 1), (2, seq, jcfg.d_model))
    out, tout, jg, tg = _vjp_both(
        lambda p_, x_: JS.ssm_forward(p_, x_, jcfg, ParallelCtx()),
        lambda p_, x_: TS.ssm_forward(p_, x_, cfg), (p, x))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    _close_tree(tg[0], jg[0])
    _close_tree(tg[1], jg[1])


@pytest.mark.parametrize("k", [1, 4])
def test_causal_conv_matches_reference(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(w))))


# --------------------------------------------------------------------------
# data, analysis, serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["musicgen-large-smoke",
                                  "internvl2-2b-smoke"])
def test_stub_batches_match_reference_specs(arch):
    """The stream's keys, shapes and dtypes are the reference's batch's;
    a shard's microbatch split cuts the frames along the batch."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = InputShape("t", 40, 4, "train")
    mine = SyntheticStream(cfg, shape, seed=1).batch_at(2)
    theirs = make_batch(jcfg, JShape("t", 40, 4, "train"),
                        jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    for k, v in mine.items():
        assert str(v.dtype).split(".")[-1] == str(theirs[k].dtype), k
    assert int(mine["labels"].max()) < cfg.vocab
    if cfg.embed_kind == "prefix":
        with pytest.raises(ValueError, match="prefix"):
            SyntheticStream(cfg, InputShape("t", 16, 4, "train")).batch_at(0)


@pytest.mark.parametrize("arch", ["musicgen-large-smoke",
                                  "internvl2-2b-smoke"])
def test_accumulation_cuts_stub_inputs(arch):
    """Two microbatches of the stubs' inputs give the full batch's
    gradient: every token's loss weighs the same, no mask, no experts."""
    cfg = get_config(arch)
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": BLOCK})
    batch = SyntheticStream(cfg, InputShape("t", 40, 4, "train"),
                            seed=0).batch_at(0)
    grads = []
    for accum in (1, 2):
        ts = init_train_state(cfg, TT.init_params(
            cfg, torch.Generator().manual_seed(0)), opt, BLOCK)
        _grads(ts, batch, accum)
        grads.append(ts.g.clone())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * float(
                                   grads[0].abs().max()))


@pytest.mark.parametrize("arch", NEW_ARCHS + ["bert-large", "llama3.2-3b"])
def test_model_math_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = InputShape("s", 4096, 8, kind)
        jshape = JShape("s", 4096, 8, kind)
        assert MM.model_flops(cfg, shape) == JMM.model_flops(jcfg, jshape)
    shape, jshape = InputShape("s", 512, 4, "train"), \
        JShape("s", 512, 4, "train")
    assert MM.layer_bwd_flops(cfg, shape) == \
        JMM.layer_bwd_flops(jcfg, jshape)
    assert MM.activation_bytes(cfg, 4, 512) == \
        JMM.activation_bytes(jcfg, 4, 512)
    assert MM.param_count_local(cfg) == JMM.param_count_local(jcfg, 1)
    assert MM.active_params_no_embed(cfg) == \
        JMM.active_params_no_embed(jcfg, 1)


@pytest.mark.parametrize("arch,match", [
    ("bert-base-smoke", "encoder"), ("bert-large-smoke", "encoder"),
    ("musicgen-large-smoke", "token prompts")])
def test_engine_refuses_encoders_and_the_audio_stub(arch, match):
    """The engine serves every decoding family with token prompts; an
    encoder does not decode, and the audio stub's frames are driven
    through ``decode_step`` directly (tests/test_torch_serve_families.py
    serves the rest)."""
    cfg = get_config(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, device="cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x22b-smoke",
                                  "falcon-mamba-7b-smoke",
                                  "jamba-1.5-large-398b-smoke"])
def test_pipelined_overlap_bitwise_serial(arch):
    """The launcher's pipelined exchange with backward overlap on a
    family arch: each bucket's exchange issued from inside backward in
    the static order of ``Transformer.grad_order`` gives the serial run
    bitwise (losses and final parameters)."""
    kw = dict(arch=arch, steps=5, warmup_steps=3, batch=4, seq=32,
              block_size=BLOCK, lr=2e-3, lr_warmup=2, device="cpu",
              verbose=False)
    serial = run(**kw)
    piped = run(pipeline=3, overlap_bwd="on", **kw)
    assert piped["n_buckets"] == 3 and piped["overlap_bwd"]
    assert [h["loss"] for h in piped["history"]] == \
        [h["loss"] for h in serial["history"]]
    assert torch.equal(piped["state"].x, serial["state"].x)
    assert piped["state"].stage0_in_bwd > 0
