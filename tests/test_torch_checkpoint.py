"""The port's checkpoints against the JAX package's.

  * A checkpoint the port writes (``repro_torch.launch.train.run(...,
    ckpt=)``, ``bert-large-smoke`` on the CPU) loads in the reference's
    ``repro.state.load_train_state`` into its own templates, and one the
    reference writes (``repro.state.save_train_state``) loads in the
    port's: the arrays are equal (exact: no arithmetic, only copies and
    reshapes), and so is the ``layout_manifest`` of the two slot sets.
  * ``slot_diff`` names a slot the archive predates, and the port's
    ``load_train_state`` starts it at zeros and warns with its name.
  * A 3 + 3 step CPU run stopped after step 4 and resumed from its
    checkpoint is bitwise the uninterrupted run: losses of steps 4-5, the
    final parameters and every state slot.
  * ``--stage`` (``run(stage_override=)``) against the reference
    launcher's: both resume 0/1 Adam (``local`` layout) from one port
    checkpoint written after 3 warmup steps and take two steps forced
    into the other stage than ``warmup_steps`` gives, on the reference's
    batches.  The steps' stage and sync (always True) agree, and so do
    the losses: rtol 2e-5 where the parameters moved by warmup steps only,
    2e-3 after a compressed update (the tolerances of
    ``tests/test_torch_family_slice.py``, which says why).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import get_optimizer as jget_optimizer  # noqa: E402
from repro.state import layout_manifest as jmanifest  # noqa: E402
from repro.state import load_train_state as jload  # noqa: E402
from repro.state import save_train_state as jsave  # noqa: E402
from repro.train.step import (init_train_state as jinit_state,  # noqa: E402
                              state_layout_ctx)
from repro_torch.checkpoint import flatten_with_keys, save_pytree  # noqa: E402
from repro_torch.convert import (params_from_flat,  # noqa: E402
                                 params_to_jax, state_to_global)
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models.transformer import leaf_shapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.state import flat_layout, layout_manifest  # noqa: E402
from repro_torch.state.checkpoint import (load_train_state,  # noqa: E402
                                          slot_diff)

ARCH = "bert-large-smoke"
BLOCK = 512
RUN = dict(arch=ARCH, warmup_steps=3, batch=4, seq=32, block_size=BLOCK,
           lr=2e-3, lr_warmup=2, device="cpu", verbose=False)
LAYOUT = {"onebit_lamb": "replicated", "zerone_adam_local": "local"}


def _jax_side(recipe):
    """The reference's templates, slots and context for this recipe."""
    from repro.configs import get_optim_recipe
    spec = get_optim_recipe(recipe)
    jopt = jget_optimizer(spec.optimizer, compressor=spec.compressor,
                          compressor_kwargs={"block_size": BLOCK},
                          **(spec.optimizer_kwargs or {}))
    layout = LAYOUT[recipe]
    cfg = jget_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    params = JT.init_params(cfg, jax.random.PRNGKey(0), tp=1)
    opt = jinit_state(cfg, mesh, block=BLOCK, layout=layout, optimizer=jopt)
    return (params, opt, jopt.state_slots(layout),
            state_layout_ctx(cfg, mesh, block=BLOCK))


def _port_arrays(res):
    ts = res["state"]
    params = params_to_jax(params_from_flat(ts.x, leaf_shapes(
        get_config(ARCH))))
    slots = res["optimizer"].state_slots(res["layout"])
    ctx = flat_layout(ts.x.shape[0], 1, ts.segs.n)
    return params, state_to_global([ts.opt], slots, ctx), slots, ctx


@pytest.mark.parametrize("recipe", ["onebit_lamb", "zerone_adam_local"])
def test_port_checkpoint_loads_in_reference(tmp_path, recipe):
    path = str(tmp_path / "port.npz")
    res = run(recipe=recipe, steps=4, ckpt=path, **RUN)
    params, glob, slots, ctx = _port_arrays(res)
    jparams, jopt, jslots, jctx = _jax_side(recipe)
    assert layout_manifest(slots, ctx, block=BLOCK) == \
        jmanifest(jslots, jctx, block=BLOCK)
    (lp, lst), step = jload(path, jparams, jopt, slots=jslots, ctx=jctx,
                            n_buckets=1, block=BLOCK)
    assert step == 4
    for k, want in flatten_with_keys(params).items():
        got = flatten_with_keys(jax.tree.map(np.asarray, lp))[k]
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert list(lst) == list(glob)
    for k in glob:
        np.testing.assert_array_equal(np.asarray(lst[k]), glob[k],
                                      err_msg=k)


@pytest.mark.parametrize("recipe", ["onebit_lamb", "zerone_adam_local"])
def test_reference_checkpoint_loads_in_port(tmp_path, recipe):
    jparams, jopt, jslots, jctx = _jax_side(recipe)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
    jopt = jopt.map(lambda a: jnp.asarray(
        rng.integers(0, 9, a.shape) if a.dtype == jnp.int32
        else rng.standard_normal(a.shape), a.dtype))
    path = str(tmp_path / "ref.npz")
    jsave(path, jparams, jopt, 7, slots=jslots, ctx=jctx, n_buckets=1,
          block=BLOCK)

    res = run(recipe=recipe, steps=0, **RUN)
    ts = res["state"]
    slots = res["optimizer"].state_slots(res["layout"])
    ctx = flat_layout(ts.x.shape[0], 1, ts.segs.n)
    (params, state), step = load_train_state(
        path, params_from_flat(ts.x, leaf_shapes(get_config(ARCH))), ts.opt,
        slots=slots, ctx=ctx, n_buckets=1, block=BLOCK)
    assert step == 7
    want = flatten_with_keys(jax.tree.map(np.asarray, jparams))
    for k, got in flatten_with_keys(params_to_jax(params)).items():
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    glob = state_to_global([state], slots, ctx)
    for k in jopt:
        np.testing.assert_array_equal(glob[k], np.asarray(jopt[k]),
                                      err_msg=k)


def test_slot_diff_names_a_missing_slot(tmp_path):
    res = run(recipe="onebit_lamb", steps=0, **RUN)
    ts = res["state"]
    slots = res["optimizer"].state_slots("replicated")
    ctx = flat_layout(ts.x.shape[0], 1, ts.segs.n)
    glob = state_to_global([ts.opt], slots, ctx)
    old = {k: v for k, v in glob.items() if k != "outer_ag_err"}
    path = str(tmp_path / "old.npz")
    params = params_from_flat(ts.x, leaf_shapes(get_config(ARCH)))
    from repro_torch.state import StateTree
    save_pytree(path, (params_to_jax(params), StateTree(old)), 3)
    with np.load(path) as data:
        keys = [k for k in data.files if not k.startswith("__")]
    assert slot_diff(ts.opt, keys) == ("outer_ag_err",)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (_, state), step = load_train_state(
            path, params, ts.opt, slots=slots, ctx=ctx, n_buckets=1,
            block=BLOCK)
    assert any("outer_ag_err" in str(w.message) for w in caught)
    assert step == 3 and not state.outer_ag_err.any()


@pytest.mark.parametrize("recipe", ["onebit_lamb", "zerone_adam_local"])
def test_resume_is_bitwise(tmp_path, recipe):
    path = str(tmp_path / "ckpt.npz")
    full = run(recipe=recipe, steps=6, **RUN)
    first = run(recipe=recipe, steps=4, ckpt=path, **RUN)
    resumed = run(recipe=recipe, steps=6, resume=path, **RUN)
    assert resumed["start_step"] == 4
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert [h["loss"] for h in first["history"]] == \
        [h["loss"] for h in full["history"][:4]]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in full["history"][4:]]
    assert [h["stage"] for h in resumed["history"]] == ["compressed"] * 2
    a, b = full["state"], resumed["state"]
    assert torch.equal(a.x, b.x)
    for k in a.opt:
        assert torch.equal(a.opt[k], b.opt[k]), k


class _ReferenceStream:
    """The reference's batches as torch tensors, in the port's stream's
    interface (its own stream draws other bits from numpy)."""

    def __init__(self, cfg, shape, seed=0, shard=0, n_shards=1,
                 device="cpu"):
        self.stream = JStream(jget_config(cfg.name), JInputShape(
            shape.name, shape.seq_len, shape.global_batch, shape.kind),
            seed=seed)
        self.device = device

    def batch_at(self, step):
        return {k: torch.from_numpy(np.array(v)).to(self.device)
                for k, v in self.stream.batch_at(step).items()}


@pytest.mark.parametrize("stage", ["warmup", "compressed"])
def test_stage_override_matches_reference(tmp_path, monkeypatch, stage):
    import repro_torch.launch.train as L
    from repro.launch.train import run as jrun
    monkeypatch.setattr(L, "SyntheticStream", _ReferenceStream)
    recipe, path = "zerone_adam_local", str(tmp_path / "ckpt.npz")
    run(recipe=recipe, steps=3, ckpt=path, **RUN)
    # without the override steps 3-4 would take the other stage
    kw = dict(RUN, warmup_steps=3 if stage == "warmup" else 5)
    port = run(recipe=recipe, steps=5, resume=path, stage_override=stage,
               **kw)["history"]
    _, _, ref = jrun(ARCH, steps=5, batch=kw["batch"], seq=kw["seq"],
                     mesh_shape=(1, 1), base_lr=kw["lr"],
                     lr_warmup=kw["lr_warmup"],
                     warmup_steps=kw["warmup_steps"], block_size=BLOCK,
                     log_every=100, resume=path, stage_override=stage,
                     recipe=recipe)
    want = [(3, stage, True), (4, stage, True)]
    assert [(h["step"], h["stage"], h["sync"]) for h in port] == want
    assert [(h["step"], h["stage"], bool(h["sync"])) for h in ref] == want
    np.testing.assert_allclose(port[0]["loss"], float(ref[0]["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(port[1]["loss"], float(ref[1]["loss"]),
                               rtol=2e-5 if stage == "warmup" else 2e-3)
