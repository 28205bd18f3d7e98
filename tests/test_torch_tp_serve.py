"""Tensor-parallel serving of the port against the JAX reference on the
CPU: ``make_serve_step`` over a dp x tp mesh of gloo ranks (spawned with a
``file://`` rendezvous under the test's tmp dir, one torch thread a rank;
``_torch_tp_serve_worker``), every decoding family's reduced config.

  * the dense (llama3.2-3b), MQA (granite-34b: its one kv head duplicated
    on every model rank), SSM, MoE (mixtral-8x22b, whose prompt passes its
    window, so the prefill seeds the ring buffer), hybrid, VLM and audio
    archs at tp 2 (mesh 1 x 2) and tp 4 (1 x 4), and llama3.2-3b and
    falcon-mamba-7b on a 2 x 2 mesh, batch-sharded and seq-sharded;
  * each against the reference's ``prefill`` / ``decode_step`` under
    ``ParallelCtx()`` on the same model: the tp global tree is the
    reference's tp = 1 tree with each kv head repeated for its duplicates
    (the vocab and q heads of the reduced configs need no padding at tp
    4), so one reference run serves every tp;
  * the prefill's logits (every vocab shard joined), its caches (joined
    over the dp and model axes, the duplicate kv heads dropped), and four
    teacher-forced decode steps' logits and final caches, at
    ``tests/test_torch_serve_families.py``'s tolerances; a MoE token whose
    top-k choices differ between the packages is counted, and the
    tolerance is held up to the first step where one reroutes (never the
    prefill);
  * ``init_caches(..., tp=)`` and ``cache_specs`` against
    the reference's global caches and PartitionSpecs for every decoding
    arch.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_tp_serve_worker as worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
B, S, STEPS = 2, 72, 4          # S passes mixtral-smoke's window of 64
ARCHS = ["llama3.2-3b", "granite-34b", "falcon-mamba-7b", "mixtral-8x22b",
         "jamba-1.5-large-398b", "internvl2-2b", "musicgen-large"]
DECODING = [a for a in list_archs() if get_config(a).family != "encoder"]


def _case(arch, mesh, seq_sharded=False):
    name = f"{arch}@{mesh}" + ("-seq" if seq_sharded else "")
    return name, dict(arch=arch, mesh=mesh, seq_sharded=seq_sharded)


CASES2 = dict(_case(a, "1x2") for a in ARCHS)
CASES4 = dict([_case(a, "1x4") for a in ARCHS]
              + [_case(a, "2x2", q) for a in ("llama3.2-3b",
                                              "falcon-mamba-7b")
                 for q in (False, True)])
ALL = {**CASES2, **CASES4}


def _tp(mesh: str) -> int:
    return int(mesh.split("x")[-1])


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jget_config(arch + "-smoke")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _reference(arch, seq_sharded):
    """The reference's serving of ``arch`` under ``ParallelCtx()``: the
    inputs, the prefill's logits and caches (none when seq-sharded, which
    decodes from zero caches), each step's logits and final caches, and
    the MoE layers' top-k choices of each phase."""
    jcfg, jparams, _ = _model(arch)
    cfg = get_config(arch + "-smoke")
    plan = worker.case_plan(cfg, seq_sharded, B, S, STEPS)
    if seq_sharded:
        pre, steps = worker.make_inputs(cfg, 2, 1, 1, len(plan["positions"]))
    else:
        pre, steps = worker.make_inputs(cfg, 1, B, S, STEPS)
    routes, jmoe = [], JM.moe_forward

    def jspy(p, x, c, ctx, *a, **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
            @ p["router"].astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), c.moe_top_k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx,
                           ordered=True)
        return jmoe(p, x, c, ctx, *a, **kw)

    def take():
        jax.effects_barrier()
        out = np.stack(routes) if routes else None
        routes.clear()
        return out
    JM.moe_forward = jspy
    try:
        out = dict(plan, pre=pre, steps=steps)
        if seq_sharded:
            jcaches = JT.init_caches(jcfg, 1, plan["cache_len"], tp=1,
                                     dtype=jnp.float32)
        else:
            out["prefill"], jcaches = JT.prefill(
                jparams, {k: jnp.asarray(v) for k, v in pre.items()}, jcfg,
                ParallelCtx(), cache_len=plan["cache_len"])
            out["caches"] = jax.tree.map(np.asarray, jcaches)
            out["routes_prefill"] = take()
        jdecode = jax.jit(lambda p, bt, c, pos: JT.decode_step(
            p, bt, c, pos, jcfg, ParallelCtx()))
        for i, (pos, st) in enumerate(zip(plan["positions"], steps)):
            logits, jcaches = jdecode(jparams, {k: jnp.asarray(v) for k, v
                                                in st.items()}, jcaches,
                                      jnp.int32(pos))
            out[f"s{i}"] = np.asarray(logits)
            out[f"routes_s{i}"] = take()
        out["final"] = jax.tree.map(np.asarray, jcaches)
    finally:
        JM.moe_forward = jmoe
    return out


def _write(workdir, cases, world):
    """The params and inputs of every case, and the cases file; returns
    the reference runs by case."""
    refs, spec = {}, {}
    for name, c in cases.items():
        cfg = get_config(c["arch"] + "-smoke")
        tp = _tp(c["mesh"])
        refs[name] = ref = _reference(c["arch"], c["seq_sharded"])
        pfile = f"params_{c['arch']}_tp{tp}.npz"
        if not os.path.exists(workdir / pfile):
            glob = worker.expand_kv(_model(c["arch"])[2], cfg, tp)
            np.savez(workdir / pfile, **{k: v.numpy()
                                         for k, v in glob.items()})
        spec[name] = worker.write_inputs(str(workdir), name, c, ref, pfile)
    worker.write_case(str(workdir), world, spec)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world, cases in ((2, CASES2), (4, CASES4)):
        workdir = tmp_path_factory.mktemp(f"tpserve{world}")
        refs = _write(workdir, cases, world)
        mp.start_processes(worker.serve_main,
                           args=(world, str(workdir), "gloo"),
                           nprocs=world, start_method="spawn")
        for name in cases:
            out[name] = (refs[name], [np.load(workdir / f"{name}_r{r}.npz")
                                      for r in range(world)])
    return out


@pytest.mark.parametrize("name", list(ALL))
def test_tp_serve_matches_reference(runs, name):
    """Prefill logits (joined vocab shards, this dp rank's rows), caches
    joined over both axes, and each decode step's logits and the final
    caches, on every rank, against the reference on the same model."""
    ref, ranks = runs[name]
    case = ALL[name]
    seq = case["seq_sharded"]
    counts, err = worker.check_case(
        ref, ranks, get_config(case["arch"] + "-smoke"), case["mesh"], seq,
        SEQ_TOL if seq else TOL)
    print(name, "tokens rerouted: prefill, then each decode step", counts,
          "max abs err", err)
    assert seq or counts[0] == 0


def test_kv_duplicates_cache_equal(runs):
    """granite-34b at tp 4: every model rank caches its own copy of the
    one kv head, bitwise equal after the prefill and the decode steps."""
    _, ranks = runs["granite-34b@1x4"]
    for key in ranks[0].files:
        if key.endswith((".k", ".v")):
            for got in ranks[1:]:
                np.testing.assert_array_equal(got[key], ranks[0][key])


def _model_dim(spec: P):
    dims = [i for i, a in enumerate(spec) if a == "model"]
    return dims[0] if dims else None


def _dp_dim(spec: P):
    dims = [i for i, a in enumerate(spec) if a not in (None, "model")]
    return dims[0] if dims else None


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", DECODING)
def test_cache_tree_at_tp_matches_reference(arch, tp):
    """``init_caches(..., tp=)`` (shapes, dtypes, zeros; 1 and 4 sequence
    shards) and ``cache_specs`` (batch- and seq-sharded)
    against the reference's global caches and PartitionSpecs at tp; every
    leaf's model dim splits over tp."""
    jcfg = jget_config(arch + "-smoke")
    cfg = get_config(arch + "-smoke")
    for shards in (1, 4):
        want = JT.init_caches(jcfg, 3, 50, tp=tp, seq_shards=shards)
        got = TT.init_caches(cfg, 3, 50, seq_shards=shards, tp=tp)
        assert sorted(got) == sorted(want)
        for name in want:
            for leaf, w in want[name].items():
                g = got[name][leaf]
                assert tuple(g.shape) == w.shape, (shards, name, leaf)
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
                assert not g.any()
    for seq_sharded in (False, True):
        want = JT.cache_specs(jcfg, "model", ("data",), seq_sharded)
        got = TT.cache_specs(cfg, seq_sharded)
        assert {n: {k: (_dp_dim(s), _model_dim(s)) for k, s in l.items()}
                for n, l in want.items()} == got
        full = TT.init_caches(cfg, 4, 64, seq_shards=2, tp=tp)
        local = TT.shard_caches(full, got, 2, tp, "cpu")
        for n, leaves in got.items():
            for k, (dp_dim, tp_dim) in leaves.items():
                shp = list(full[n][k].shape)
                shp[tp_dim] //= tp
                if dp_dim is not None:
                    shp[dp_dim] //= 2
                assert list(local[n][k].shape) == shp
