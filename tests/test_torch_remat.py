"""``remat_policy="dots"``: the reference's selective recompute that keeps
the outputs of the products without batch dimensions
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``), in the
port as ``torch.utils.checkpoint`` with ``models.common.save_dots``.

  * (a) the saved set, one superblock of each family's reduced config
    (BERT encoder, dense GQA, MoE under both dispatches, SSM, the Jamba
    hybrid, the VLM prefix, the audio embeddings): the shapes of the
    products the port's policy saves equal the shapes of the products
    without batch dimensions in the reference's traced superblock (rows
    flattened: the port's ``dense`` folds (B, S, d) into one (B*S, d)
    product).  The reference's ``saved_residuals`` under its policy are
    those products less the ones no backward step reads, which JAX drops:
    the superblock's last projection when it only joins the residual
    stream, and under einsum dispatch each expert's down projection (only
    the one-hot combine reads it, and that product is saved).  The
    port's checkpoint keeps both: its recompute stops before the first
    and runs through the second on its way (keeping it spares that
    product's recompute).  The test holds the difference to exactly
    those shapes;
  * (b) the loss and every gradient under ``"dots"``, ``"block"`` and
    ``remat=False`` bitwise equal: at tp 1 for every arch's reduced
    config (and the MoE gather dispatch), and at tp 2 and SP 2 over gloo
    ranks (dense, MoE, SSM; ``_torch_tp_worker.model_main``, a
    ``file://`` rendezvous of its own under the test's tmp dir);
  * (c) the port's ``"dots"`` loss and flat gradient against the
    reference's ``"dots"`` on the same tree and batch, at
    ``tests/test_torch_families.py``'s tolerances (loss rtol 1e-5,
    gradient rtol 1e-4 with an atol of 1e-5 of its largest entry);
  * (d) the dry run on meta tensors (``launch.dryrun.lower_one`` with
    ``cfg_overrides``, rank 0 of a fake 2 x 2 mesh): the ``mm`` FLOPs
    under ``"dots"`` are those of ``remat=False`` exactly, its ``bmm``
    FLOPs those of ``"block"``, and its traced peak lies between the two;
  * (e) on the card (``cuda`` marker): ``"dots"`` bitwise ``"block"`` in
    bf16.

The reference is imported inside the tests that use it, so the file also
runs on a machine without JAX (the card tests).
"""
import collections
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

from torch.utils.checkpoint import (CheckpointPolicy,  # noqa: E402
                                    checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, InputShape  # noqa: E402
from repro_torch.convert import flat_from_params  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import save_dots  # noqa: E402
from repro_torch.models.mlp import moe_capacity  # noqa: E402

import _torch_tp_worker as worker  # noqa: E402

# one case a family: (reduced arch, config overrides)
FAMILIES = {
    "bert": ("bert-large-smoke", {}),
    "dense_gqa": ("llama3.2-3b-smoke", {}),
    "moe_einsum": ("mixtral-8x22b-smoke", {}),
    "moe_gather": ("mixtral-8x22b-smoke", {"moe_dispatch": "gather"}),
    "ssm": ("falcon-mamba-7b-smoke", {}),
    "hybrid": ("jamba-1.5-large-398b-smoke", {}),
    "vlm_prefix": ("internvl2-2b-smoke", {}),
    "audio_embeddings": ("musicgen-large-smoke", {}),
}
POLICIES = {"none": {"remat": False}, "block": {"remat_policy": "block"},
            "dots": {"remat_policy": "dots"}}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_SHARE = 1e-5
B, S = 2, 32


def _rows(shape):
    """(rows, cols) of a product's output: every leading dim is a row."""
    return (int(np.prod(shape[:-1])), int(shape[-1]))


def _seq(cfg) -> int:
    return cfg.n_prefix + 16 if cfg.embed_kind == "prefix" else S


# --------------------------------------------------------------------------
# (a) the saved set against the reference's
# --------------------------------------------------------------------------

def _ref_superblock(arch, over):
    """The reference's superblock body of ``arch``'s reduced config (as
    ``src/repro/models/transformer.py``'s ``_run_blocks`` builds it), its
    first superblock's params and an input."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import transformer as JT
    from repro.models.common import ParallelCtx
    jcfg = dataclasses.replace(jget_config(arch), **over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    layout = JT._superblock_layout(jcfg)
    ctx = ParallelCtx()

    def sb_body(x, sb_params):
        aux = jnp.zeros((), jnp.float32)
        for i, (mx, ff) in enumerate(layout):
            x, a = JT._layer_fwd(sb_params[f"l{i}"], x, jcfg, ctx, mx, ff)
            aux = aux + a
        return x, aux
    sbp = jax.tree.map(lambda a: a[0], params["blocks"])
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return sb_body, sbp, jnp.asarray(x), params


def _no_batch_dots(jaxpr, out):
    """Output shapes of every ``dot_general`` without batch dimensions in
    ``jaxpr`` and its sub-jaxprs."""
    from jax.extend import core as jcore
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            _, (lhs_b, rhs_b) = eqn.params["dimension_numbers"]
            if not lhs_b and not rhs_b:
                out.append(_rows(eqn.outvars[0].aval.shape))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _no_batch_dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _no_batch_dots(sub, out)
    return out


def _port_saved(cfg, params, x):
    """Shapes of the outputs the port's policy saves in one checkpointed
    forward of the first superblock (each op re-run on meta tensors)."""
    from repro_torch.convert import params_from_jax
    import jax
    flat = flat_from_params(params_from_jax(jax.tree.map(np.asarray,
                                                         params)))
    model = TT.Transformer(cfg, flat)
    shapes = []

    def recording(ctx, func, *args, **kwargs):
        policy = save_dots(ctx, func, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            meta = torch.utils._pytree.tree_map_only(
                torch.Tensor, lambda t: t.to("meta"), (args, kwargs))
            shapes.append(_rows(func(*meta[0], **meta[1]).shape))
        return policy
    h = torch.tensor(np.asarray(x), requires_grad=True)
    out, _ = checkpoint(
        functools.partial(TT._superblock, model.superblocks()[0]), h,
        use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(recording))
    out.sum().backward()
    return shapes


def _dropped_by_jax(cfg, tokens):
    """The products the reference's AD leaves out of its residuals: each
    expert's down projection under einsum dispatch (only the saved
    combine reads it), and the superblock's last projection when its
    last layer ends in one (it only joins the residual stream)."""
    out = collections.Counter()
    layout = TT.superblock_layout(cfg)
    for _, ffn in layout:
        if ffn == "moe" and cfg.moe_dispatch == "einsum":
            out[(moe_capacity(cfg, tokens), cfg.d_model)] += cfg.n_experts
    if layout[-1][1] != "moe":
        out[(tokens, cfg.d_model)] += 1
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_saved_set_matches_reference(family):
    import jax
    from jax._src.ad_checkpoint import saved_residuals
    arch, over = FAMILIES[family]
    sb_body, sbp, x, params = _ref_superblock(arch, over)
    dots = collections.Counter(_no_batch_dots(
        jax.make_jaxpr(sb_body)(x, sbp).jaxpr, []))
    body = jax.checkpoint(
        sb_body,
        policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    residuals = collections.Counter(
        _rows(aval.shape) for aval, why in saved_residuals(body, x, sbp)
        if not why.startswith("from the argument"))
    cfg = dataclasses.replace(get_config(arch), **over)
    saved = collections.Counter(_port_saved(cfg, params, x))
    assert saved == dots
    assert sum(saved.values()) > 0
    assert residuals - saved == collections.Counter()
    assert saved - residuals == _dropped_by_jax(cfg, B * S)


# --------------------------------------------------------------------------
# (b) bitwise across policies
# --------------------------------------------------------------------------

def _loss_and_grad(cfg, batch, seed=0):
    params = TT.init_params(cfg, torch.Generator().manual_seed(seed))
    flat = flat_from_params(params)
    g = torch.zeros_like(flat)
    model = TT.Transformer(cfg, flat)
    model.bind_grads(g)
    total, met = TT.loss_fn(model, batch)
    total.backward()
    return total.detach(), met["loss"].detach(), g


@pytest.mark.parametrize("arch,over", [(a + "-smoke", {})
                                       for a in list_archs()]
                         + [("mixtral-8x22b-smoke",
                             {"moe_dispatch": "gather"})])
def test_policies_bitwise_at_tp1(arch, over):
    base = dataclasses.replace(get_config(arch), **over)
    batch = SyntheticStream(base, InputShape("t", _seq(base), B, "train"),
                            seed=0).batch_at(0)
    got = {name: _loss_and_grad(dataclasses.replace(base, **fields), batch)
           for name, fields in POLICIES.items()}
    want = got["none"]
    assert torch.isfinite(want[0]) and float(want[2].abs().max()) > 0
    for name in ("block", "dots"):
        for a, b in zip(got[name], want):
            assert torch.equal(a, b), name


TP_ARCHS = ["llama3.2-3b", "mixtral-8x22b", "falcon-mamba-7b"]


def test_policies_bitwise_at_tp2_and_sp2(tmp_path):
    """2 gloo ranks, one model axis of 2, under TP and under SP: each
    rank's loss and gradient shard bitwise across the three policies."""
    cases = {}
    for arch in TP_ARCHS:
        cfg = get_config(arch + "-smoke")
        glob = TT.init_params(cfg, torch.Generator().manual_seed(0), tp=2)
        batch = SyntheticStream(cfg, InputShape("t", S, B, "train"),
                                seed=0).batch_at(0)
        arrays = {f"p:{k}": v.numpy() for k, v in glob.items()}
        arrays.update({f"b:{k}": v.numpy() for k, v in batch.items()})
        np.savez(tmp_path / f"{arch}.npz", **arrays)
        for sp in (False, True):
            for pol, fields in POLICIES.items():
                cases[f"{arch}_sp{int(sp)}_{pol}"] = {
                    "cfg": dict(arch=arch + "-smoke", **fields),
                    "mesh": "1x2", "sp": sp, "data": arch}
    with open(tmp_path / "cases2.json", "w") as f:
        json.dump(cases, f)
    mp.start_processes(worker.model_main, args=(2, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    for arch in TP_ARCHS:
        for sp in (0, 1):
            for r in range(2):
                res = {pol: np.load(tmp_path / f"{arch}_sp{sp}_{pol}_r{r}.npz")
                       for pol in POLICIES}
                want = res["none"]
                assert np.isfinite(want["total"])
                assert np.abs(want["grad"]).max() > 0
                for pol in ("block", "dots"):
                    for key in ("total", "loss", "grad"):
                        np.testing.assert_array_equal(
                            res[pol][key], want[key],
                            err_msg=f"{arch} sp{sp} rank {r} {pol} {key}")


# --------------------------------------------------------------------------
# (c) against the reference's "dots"
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_matches_reference_dots(family):
    import jax
    from jax.flatten_util import ravel_pytree
    from repro.configs import get_config as jget_config
    from repro.configs.base import InputShape as JShape
    from repro.data import make_batch
    from repro.models import transformer as JT
    from repro.models.common import ParallelCtx
    from repro_torch.convert import params_from_jax
    arch, over = FAMILIES[family]
    over = dict(over, remat_policy="dots")
    jcfg = dataclasses.replace(jget_config(arch), **over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    batch = make_batch(jcfg, JShape("t", _seq(jcfg), B, "train"),
                       jax.random.PRNGKey(100))
    (jtotal, jmet), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, batch, jcfg, ParallelCtx())
    want = np.asarray(ravel_pytree(jgrads)[0])

    cfg = dataclasses.replace(get_config(arch), **over)
    flat = flat_from_params(params_from_jax(jax.tree.map(np.asarray,
                                                         params)))
    g = torch.zeros_like(flat)
    model = TT.Transformer(cfg, flat)
    model.bind_grads(g)
    total, met = TT.loss_fn(model, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["loss"].detach()),
                               float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * float(
                                   np.abs(want).max()))


# --------------------------------------------------------------------------
# (d) the dry run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x22b",
                                  "falcon-mamba-7b"])
def test_dry_run_flop_identity(arch):
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128)
    rep = {pol: dryrun.lower_one(arch + "-smoke", shape, mesh_override="2x2",
                                 cfg_overrides=fields)
           for pol, fields in POLICIES.items()}

    def flops(pol, *ops):
        return sum(rep[pol]["flops_by_op"].get(op, 0) for op in ops)
    mm = ("aten.mm", "aten.addmm")
    assert flops("dots", *mm) == flops("none", *mm) > 0
    assert flops("block", *mm) > flops("none", *mm)
    assert flops("dots", "aten.bmm") == flops("block", "aten.bmm") > \
        flops("none", "aten.bmm")
    peak = {pol: r["memory"]["peak_bytes"] for pol, r in rep.items()}
    assert peak["block"] <= peak["dots"] <= peak["none"], peak
    assert rep["dots"]["cfg_overrides"] == {"remat_policy": "dots"}


# --------------------------------------------------------------------------
# (e) on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["bert-large-smoke", "llama3.2-3b-smoke",
                                  "mixtral-8x22b-smoke",
                                  "falcon-mamba-7b-smoke"])
def test_dots_bitwise_block_on_the_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    base = dataclasses.replace(get_config(arch), compute_dtype="bfloat16")
    batch = SyntheticStream(base, InputShape("t", _seq(base), B, "train"),
                            seed=0, device="cuda").batch_at(0)
    got = {}
    for pol in ("block", "dots"):
        cfg = dataclasses.replace(base, **POLICIES[pol])
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        flat = flat_from_params(params)
        g = torch.zeros_like(flat)
        model = TT.Transformer(cfg, flat)
        model.bind_grads(g)
        total, _ = TT.loss_fn(model, batch)
        total.backward()
        got[pol] = (total.detach(), g)
    assert torch.isfinite(got["block"][0])
    assert torch.equal(got["dots"][0], got["block"][0])
    assert torch.equal(got["dots"][1], got["block"][1])
