"""The port's BERT encoder against the JAX reference model.

Parameters initialised by ``repro.models.transformer.init_params`` are
carried across as numpy (``repro_torch.convert``); the same numpy batch
goes through JAX ``loss_fn`` under ``jax.value_and_grad`` and through the
port's module with its backward into the flat gradient.  The smoke config
computes in f32 (TF32 plays no part on the CPU), so the loss agrees to
rtol 1e-5; the gradient is a sum over the batch in another order, so it
agrees to rtol 1e-4 with an atol of 1e-5 of its largest entry.

The flat order is pinned bitwise: the port's flat vector is
``ravel_pytree`` of the reference's parameters, and the full-size
BERT-Large layout has the reference's leaf order, shapes and padded size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.data import make_batch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro.train.step import _flat_dim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import flat_from_params, params_from_jax  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.step import flat_dim  # noqa: E402

ARCH = "bert-large-smoke"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(seed, b=2, s=32):
    jcfg = jget_config(ARCH)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed), tp=1)
    batch = make_batch(jcfg, InputShape("t", s, b, "train"),
                       jax.random.PRNGKey(100 + seed))
    return jcfg, params, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(seed):
    jcfg, params, batch = _setup(seed)
    (jtotal, jmet), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, batch, jcfg, ParallelCtx())
    jflat_g, _ = ravel_pytree(jgrads)

    cfg = get_config(ARCH)
    flat = flat_from_params(params_from_jax(_np_tree(params)))
    model = TT.Transformer(cfg, flat)
    gflat = torch.zeros_like(flat)
    model.bind_grads(gflat)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    total, met = TT.loss_fn(model, tbatch)
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["acc"]), float(jmet["acc"]),
                               atol=1e-6)
    want = np.asarray(jflat_g)
    np.testing.assert_allclose(gflat.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 2])
def test_flat_order_is_ravel_pytree(seed):
    _, params, _ = _setup(seed)
    jflat, _ = ravel_pytree(params)
    tparams = params_from_jax(_np_tree(params))
    np.testing.assert_array_equal(flat_from_params(tparams).numpy(),
                                  np.asarray(jflat))
    # the module's parameters are views of the flat vector, at the same
    # offsets: writing the flat vector writes the model
    flat = flat_from_params(tparams)
    model = TT.Transformer(get_config(ARCH), flat)
    with torch.no_grad():
        flat.mul_(2.0)
    np.testing.assert_array_equal(
        model.blocks[1].mixer["wq"].detach().numpy(),
        2.0 * np.asarray(params["blocks"]["l0"]["mixer"]["wq"][1]))


@pytest.mark.parametrize("arch", ["bert-large", "bert-large-smoke",
                                  "bert-base", "llama3.2-3b",
                                  "internlm2-1.8b", "internlm2-1.8b-smoke"])
def test_layout_matches_reference(arch):
    """Leaf paths, shapes and the padded flat length, without allocating
    (bert-large: d = 364,561,408, d_pad = 364,564,480 at block 4096;
    llama3.2-3b: d = 3,606,752,256)."""
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k, tp=1),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = [(".".join(p.key for p in path), tuple(leaf.shape))
            for path, leaf in leaves]
    cfg = get_config(arch)
    assert TT.leaf_shapes(cfg) == want
    for n_dp, block in ((1, 4096), (4, 4096), (2, 512)):
        assert flat_dim(cfg, n_dp, block) == _flat_dim(jcfg, 1, n_dp, block)
    if arch == "bert-large":
        assert TT.flat_size(cfg) == 364_561_408
        assert flat_dim(cfg, 1, 4096) == 364_564_480
    if arch == "llama3.2-3b":
        assert TT.flat_size(cfg) == 3_606_752_256


def test_init_matches_reference_distributions():
    cfg = get_config(ARCH)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    _, jparams, _ = _setup(0)
    jleaves = dict(zip(
        (p for p, _ in TT.leaf_shapes(cfg)), jax.tree.leaves(jparams)))
    for path, t in params.items():
        want = np.asarray(jleaves[path])
        assert t.dtype == torch.float32 and tuple(t.shape) == want.shape
        np.testing.assert_allclose(float(t.std()), float(want.std()),
                                   rtol=0.1)
        np.testing.assert_allclose(float(t.mean()), float(want.mean()),
                                   atol=0.05 * max(float(want.std()), 1e-3))


def test_synthetic_stream_structure():
    cfg = get_config(ARCH)
    shape = InputShape("t", 64, 8, "train")
    b0 = SyntheticStream(cfg, shape, seed=3, shard=0, n_shards=2).batch_at(5)
    b0_again = SyntheticStream(cfg, shape, seed=3, shard=0,
                               n_shards=2).batch_at(5)
    b1 = SyntheticStream(cfg, shape, seed=3, shard=1, n_shards=2).batch_at(5)
    assert set(b0) == {"tokens", "labels", "loss_mask"}
    assert b0["tokens"].shape == (4, 64) and b0["tokens"].dtype == torch.int32
    assert all(torch.equal(b0[k], b0_again[k]) for k in b0)
    assert not torch.equal(b0["labels"], b1["labels"])
    mask = b0["loss_mask"] > 0
    assert 0.05 < float(mask.float().mean()) < 0.3
    assert bool((b0["tokens"][mask] == cfg.vocab - 1).all())
    assert bool((b0["tokens"][~mask] == b0["labels"][~mask]).all())
    assert int(b0["labels"].max()) < cfg.vocab
