"""Backward overlap and the pipelined exchange in training, on gloo ranks.

``bert-large-smoke`` (f32), 3 warmup + 2 compressed steps of 1-bit Adam
through ``train_step``, on 2 ranks (one dp axis, the flat exchange) and on
4 ranks as 2 pods x 2 (the hierarchical exchange), each serially and with
``n_buckets=3, overlap_bwd=True``; also with ``accum_steps=2`` and with
the compressed steps under zero1.  The overlapped run is bitwise the
serial one on every rank: losses, parameters, every state slot (the
chunk EF slots once keyed canonically, ``repro_torch.state.to_canonical``:
which elements a rank serves depends on the bucket partition).

A single process checks that the first stages really issue from inside
backward: the parameters' gradients land in the model's static
``grad_order``; the buckets issue in ``backward_ready_order`` (the
embedding's bucket, whose gradient lands last, goes last); every bucket
but that one issues its stage 0 before the embedding's gradient lands,
and all of them have issued when ``backward()`` returns.

The hierarchical run's losses are held to the reference's
``make_train_step`` on a (2, 2, 1) ("pod", "data", "model") mesh with
``topology="hier"`` (a subprocess with forced host devices; the same
parameters and the same per-rank batches) at
``tests/test_torch_family_slice.py``'s tolerances and for its reasons:
rtol 2e-5 up to step 3, 2e-3 after the first compressed update.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import _torch_hier_worker as worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_to_jax, state_to_global  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.pipeline import Bucketer  # noqa: E402
from repro_torch.state import StateLayout, to_canonical  # noqa: E402
from repro_torch.train.step import flat_dim, segment_info  # noqa: E402

ARCH = "bert-large-smoke"
BLOCK = 512
NB = 3
BASE = dict(arch=ARCH, block=BLOCK, seq=32, batch=8, steps=5, warmup=3)
LOSS_RTOL_WARMUP = 2e-5
LOSS_RTOL_COMPRESSED = 2e-3
REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"flat2": ("2", "flat", (2,)), "hier4": ("2x2x1", "hier", (2, 2))}
VARIANTS = {"plain": {}, "accum": {"accum": 2}, "zero1": {"zero1": True}}


def _runs(mesh, topology):
    out = {}
    for v, extra in VARIANTS.items():
        for tag, nb, ov in (("serial", 1, False), ("overlap", NB, True)):
            out[f"{v}_{tag}"] = dict(BASE, mesh=mesh, topology=topology,
                                     n_buckets=nb, overlap=ov, **extra)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Each mesh's ranks run once per module: mesh name -> every rank's
    saved runs."""
    cache = {}

    def get(name):
        if name not in cache:
            mesh, topology, sizes = MESHES[name]
            workdir = tmp_path_factory.mktemp(name)
            with open(workdir / "runs.json", "w") as f:
                json.dump(_runs(mesh, topology), f)
            n = int(np.prod(sizes))
            mp.start_processes(worker.steps_main,
                               args=(n, str(workdir), "gloo"), nprocs=n,
                               start_method="spawn")
            cache[name] = [np.load(workdir / f"steps{r}.npz")
                           for r in range(n)]
        return cache[name]
    return get


def _ctx(sizes, topology):
    cfg = get_config(ARCH)
    n = int(np.prod(sizes))
    d_pad = flat_dim(cfg, n, BLOCK)
    hier = topology == "hier"
    return StateLayout(d=d_pad, n_dp=n, n_srv=sizes[-1] if hier else n,
                       n_outer=sizes[0] if hier else 1,
                       n_segments=segment_info(cfg, d_pad).n,
                       dp_sizes=tuple(sizes), tp=1)


def _global(ranks, run, slots, ctx, nb):
    states = [{s.name: torch.from_numpy(r[f"{run}__opt_{s.name}"])
               for s in slots} for r in ranks]
    return to_canonical(state_to_global(states, slots, ctx), slots, ctx,
                        n_buckets=nb, block=BLOCK)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_overlap_bitwise_serial(spawned, name, variant):
    got = spawned(name)
    mesh, topology, sizes = MESHES[name]
    ser, ovl = f"{variant}_serial", f"{variant}_overlap"
    for r in got:
        np.testing.assert_array_equal(r[ovl + "__loss"], r[ser + "__loss"])
        np.testing.assert_array_equal(r[ovl + "__x"], r[ser + "__x"])
        np.testing.assert_array_equal(r[ovl + "__x"], got[0][ovl + "__x"])
        assert np.isfinite(r[ser + "__loss"]).all()
    layout = "zero1" if variant == "zero1" else "replicated"
    slots = get_optimizer("onebit_adam").state_slots(layout)
    assert {f"{ser}__opt_{s.name}" for s in slots} <= set(got[0].files)
    ctx = _ctx(sizes, topology)
    a = _global(got, ser, slots, ctx, 1)
    b = _global(got, ovl, slots, ctx, NB)
    for s in slots:
        np.testing.assert_array_equal(b[s.name], a[s.name], err_msg=s.name)
    assert np.abs(a["server_err"]).sum() > 0


def test_first_stages_issue_inside_backward(monkeypatch):
    from repro_torch.train import step as tstep
    cfg = get_config(ARCH)
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": BLOCK})
    ts = tstep.init_train_state(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)), opt, BLOCK)
    stream = SyntheticStream(cfg, InputShape("t", 32, 4, "train"), seed=0)
    names = {id(p): n for n, p in ts.model.named_parameters()}
    fired, seen = [], []
    for p in ts.model.parameters():
        p.register_post_accumulate_grad_hook(
            lambda p: fired.append(names[id(p)]))
    orig = tstep._Overlap.remove_hooks

    def remove_hooks(self):
        seen.append((self.ex.order, sorted(self.ex.issued), self.early))
        orig(self)

    monkeypatch.setattr(tstep._Overlap, "remove_hooks", remove_hooks)
    for step in range(4):
        fired.clear()
        tstep.train_step(ts, opt, stream.batch_at(step), 1e-3,
                         "warmup" if step < 3 else "compressed",
                         n_buckets=NB, overlap_bwd=True)
    assert fired == [names[id(p)] for p in ts.model.grad_order()]
    assert fired[-1] == "embed"
    bk = Bucketer.for_exchange(ts.x.shape[0], 1, BLOCK, NB)
    lo = (ts.model.embed.data_ptr() - ts.x.data_ptr()) // 4
    emb = max(b for b in range(NB) if bk.offsets[b] <= lo)
    order = tuple(b for b in range(NB) if b != emb) + (emb,)
    assert seen == [(order, [(b, 0) for b in range(NB)], NB - 1)]
    assert ts.stage0_in_bwd == NB - 1


REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.train.step import (TrainStepConfig, init_train_state,
                              make_train_step)

workdir, block = sys.argv[1], int(sys.argv[2])
data = np.load(workdir + "/ref_inputs.npz")
cfg = get_config("bert-large-smoke")
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
tsc = TrainStepConfig(optimizer="onebit_adam", compressor="onebit",
                      block_size=block, topology="hier")
steps = {s: make_train_step(cfg, mesh, dataclasses.replace(tsc, stage=s),
                            donate=False)
         for s in ("warmup", "compressed")}
opt = init_train_state(cfg, mesh, block=block, topology="hier",
                       optimizer=steps["warmup"].optimizer)
params = json.loads(open(workdir + "/ref_params.json").read())

def build(node):
    if isinstance(node, dict):
        return {k: build(v) for k, v in node.items()}
    return jnp.asarray(data["p_" + node])

params = build(params)
losses = []
for step in range(int(data["steps"])):
    stage = "warmup" if step < int(data["warmup"]) else "compressed"
    batch = {k[len(f"b{step}_"):]: jnp.asarray(v) for k, v in data.items()
             if k.startswith(f"b{step}_")}
    params, opt, m = steps[stage](params, opt, batch,
                                  jnp.float32(data["lr"][step]))
    losses.append(float(m["loss"]))
np.save(workdir + "/ref_losses.npy", np.array(losses))
print("OK")
"""


def _reference_losses(workdir):
    from repro_torch.launch.train import lr_schedule
    cfg = get_config(ARCH)
    flat = {}

    def names(node, prefix=""):
        if isinstance(node, dict):
            return {k: names(v, f"{prefix}{k}.") for k, v in node.items()}
        flat[prefix[:-1]] = np.asarray(node)
        return prefix[:-1]

    tree = names(params_to_jax(init_params(
        cfg, torch.Generator().manual_seed(0))))
    with open(workdir / "ref_params.json", "w") as f:
        json.dump(tree, f)
    arrays = {"p_" + k: v for k, v in flat.items()}
    shards = [SyntheticStream(cfg, InputShape("t", BASE["seq"],
                                              BASE["batch"], "train"),
                              seed=0, shard=r, n_shards=4) for r in range(4)]
    for step in range(BASE["steps"]):
        parts = [s.batch_at(step) for s in shards]
        for k in parts[0]:
            arrays[f"b{step}_{k}"] = np.concatenate(
                [p[k].numpy() for p in parts])
    arrays.update(steps=BASE["steps"], warmup=BASE["warmup"],
                  lr=np.array([lr_schedule(s, 2e-3, 2)
                               for s in range(BASE["steps"])], np.float32))
    np.savez(workdir / "ref_inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=REPO_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(workdir), str(BLOCK)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return np.load(workdir / "ref_losses.npy")


def test_hier_losses_match_reference(spawned, tmp_path):
    got = spawned("hier4")
    want = _reference_losses(tmp_path)
    w = BASE["warmup"]
    for tag in ("plain_serial", "plain_overlap"):
        loss = got[0][f"{tag}__loss"]
        np.testing.assert_allclose(loss[:w + 1], want[:w + 1],
                                   rtol=LOSS_RTOL_WARMUP)
        np.testing.assert_allclose(loss[w + 1:], want[w + 1:],
                                   rtol=LOSS_RTOL_COMPRESSED)
