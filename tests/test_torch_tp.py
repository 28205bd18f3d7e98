"""Tensor, sequence and expert parallelism of the port against the JAX
reference on the CPU, over gloo ranks spawned with a ``file://``
rendezvous under the test's tmp dir (one torch thread a rank).

  * the eight collectives of ``models.common`` forward and backward over
    2 and 4 ranks against their definitions (numpy on every rank's
    inputs);
  * for all 12 archs at tp 2 and 4: ``param_specs`` and the global leaf
    shapes against the reference's ``param_specs`` / ``init_params(...,
    tp=)``, each model rank's flat length and segment count against the
    reference's ``_flat_dim`` / ``_n_segments`` (full size, shapes only),
    and shard -> unshard of the reference's reduced tree bitwise;
  * the reference's TP-parity set: the port at tp = 2 against the
    reference's ``loss_fn`` under ``ParallelCtx()`` (one device) on the
    same tp = 2 global tree (llama3.2-3b, mixtral-8x22b,
    jamba-1.5-large-398b, falcon-mamba-7b reduced, capacity factor 64 so
    no token drops: drop order is rank-local under TP), loss rtol 1e-5,
    every leaf's gradient max-relative error 1e-4; the BERT encoder the
    same way;
  * granite-34b at tp = 4 (MQA: its one kv head duplicated on all four
    ranks) and a MoE with 2 experts at tp = 4 (each expert's d_ff split
    over two ranks), against the reference at tp = 1 on the same model
    (the duplicate kv columns and the ff slices joined), the kv
    gradients bitwise equal across the duplicates;
  * sequence parallelism against TP: dense, SSM and VLM against the
    reference's TP loss and gradients on the same tree (loss rtol 1e-5,
    gradient 1e-4); MoE against the port's TP run at 0.2 (a reassociated
    sum can flip a top-k tie).
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.data import make_batch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParallelCtx as JCtx  # noqa: E402
from repro.optim import TwoStageOptimizer as JOpt  # noqa: E402
from repro.state import StateLayout as JLayout  # noqa: E402
from repro.state import layout_manifest as jlayout_manifest  # noqa: E402
from repro.train.step import _flat_dim, _n_segments  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.optim import TwoStageOptimizer  # noqa: E402
from repro_torch.convert import (flat_from_params,  # noqa: E402
                                 params_from_jax, shard_params,
                                 unshard_params)
from repro_torch.benchmarks import state_manifest as TMAN  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.state import flat_layout, global_shapes  # noqa: E402
from repro_torch.train.step import flat_dim, segment_info  # noqa: E402

import _torch_tp_worker as worker  # noqa: E402

ARCHS = list_archs()
PARITY = ["llama3.2-3b", "mixtral-8x22b", "jamba-1.5-large-398b",
          "falcon-mamba-7b"]
SP_TOL = {"llama3.2-3b": 1e-5, "falcon-mamba-7b": 1e-5,
          "internvl2-2b": 1e-5, "mixtral-8x22b": 0.2}


def _spawn(fn, world, workdir):
    mp.start_processes(fn, args=(world, str(workdir)), nprocs=world,
                       start_method="spawn")


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------

def _coll_ranks(world, tmp_path_factory):
    workdir = tmp_path_factory.mktemp(f"coll{world}")
    _spawn(worker.collectives_main, world, workdir)
    return [np.load(workdir / f"coll{world}_{r}.npz") for r in range(world)]


@pytest.fixture(scope="module")
def coll4(tmp_path_factory):
    return _coll_ranks(4, tmp_path_factory)


@pytest.fixture(scope="module", params=[2, 4])
def coll(request, tmp_path_factory, coll4):
    if request.param == 4:
        return 4, coll4
    return 2, _coll_ranks(2, tmp_path_factory)


def _expected(name: str, sp: bool, world: int, r: int):
    xs, cts = zip(*[worker.coll_inputs(q) for q in range(world)])
    s = worker.COLL_SHAPE[1]
    c = s // world
    x, ct = xs[r], cts[r]
    zero = np.zeros_like(x)
    if name == "g_copy" or (name == "rep_param" and sp):
        return x, sum(cts)
    if name == "rep_param":
        return x, ct
    if name == "f_reduce":
        return sum(xs), ct
    if name == "pmean":
        return sum(xs) / world, sum(cts) / world
    if name == "sp_gather":
        g = zero.copy()
        g[:, :c] = sum(q[:, r * c:(r + 1) * c] for q in cts)
        return np.concatenate([q[:, :c] for q in xs], axis=1), g
    if name == "sp_scatter":
        return (sum(xs)[:, r * c:(r + 1) * c],
                np.concatenate([q[:, :c] for q in cts], axis=1))
    if name == "sp_slice":
        g = zero.copy()
        g[:, r * c:(r + 1) * c] = ct[:, :c]
        return x[:, r * c:(r + 1) * c], g
    rep = int(name[-1])
    lo = (r // rep) * rep
    return x, sum(cts[lo:lo + rep])


OPS = ["g_copy", "f_reduce", "rep_param", "pmean", "sp_gather",
       "sp_scatter", "sp_slice"]
OPS4 = ["grouped_param2", "grouped_param4"]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("name", OPS)
def test_collective_matches_definition(coll, name, sp):
    _check_collective(*coll, name, sp)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("name", OPS4)
def test_grouped_param_matches_definition(coll4, name, sp):
    _check_collective(4, coll4, name, sp)


def _check_collective(world, ranks, name, sp):
    for r, got in enumerate(ranks):
        y, g = _expected(name, sp, world, r)
        key = f"{name}_sp{int(sp)}"
        np.testing.assert_allclose(got[key + "_y"], y, rtol=1e-6,
                                   atol=1e-6, err_msg=f"{key} fwd rank {r}")
        np.testing.assert_allclose(got[key + "_g"], g, rtol=1e-6,
                                   atol=1e-6, err_msg=f"{key} bwd rank {r}")
        assert int(got["tp_rank"]) == r


# --------------------------------------------------------------------------
# layout: specs, shapes, flat lengths, shard / unshard
# --------------------------------------------------------------------------

def _ref_specs(cfg, tp):
    """The reference's PartitionSpecs as {dotted path: split dim}."""
    tree = JT.param_specs(cfg, "model", tp)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    out = {}
    for path, spec in flat:
        key = ".".join(p.key for p in path)
        dims = [i for i, a in enumerate(spec) if a == "model"]
        out[key] = dims[0] if dims else None
    return out


def _ref_shapes(cfg, tp):
    tree = jax.eval_shape(lambda k: JT.init_params(cfg, k, tp=tp),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in flat}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_reference(arch, tp):
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs = TT.param_specs(cfg)
    assert specs == _ref_specs(jcfg, tp)
    shapes = TT.global_leaf_shapes(cfg, tp)
    assert dict(shapes) == _ref_shapes(jcfg, tp)
    assert [p for p, _ in shapes] == sorted(specs, key=lambda p:
                                            p.split("."))
    assert cfg.param_count(tp) == jcfg.param_count(tp)
    d_pad = flat_dim(cfg, 4, 512, tp)
    assert d_pad == _flat_dim(jcfg, tp, 4, 512)
    n_seg = segment_info(cfg, d_pad, tp).n
    assert n_seg == _n_segments(jcfg, tp, d_pad)
    shapes_g = global_shapes(TwoStageOptimizer().state_slots(),
                             flat_layout(d_pad, 4, n_seg, tp))
    assert shapes_g["worker_err"][0] == (4, tp, d_pad)
    assert shapes_g["m"][0] == (tp, d_pad)

    # the reference's reduced tree cut into shards and joined, bitwise
    rcfg, jrcfg = get_config(arch + "-smoke"), jcfg.reduced()
    glob = params_from_jax(JT.init_params(jrcfg, jax.random.PRNGKey(1),
                                          tp=tp))
    rspecs = TT.param_specs(rcfg)
    shards = [shard_params(glob, rspecs, tp, r) for r in range(tp)]
    local = dict(TT.leaf_shapes(rcfg, tp))
    for sh in shards:
        assert {p: tuple(t.shape) for p, t in sh.items()} == local
        assert flat_from_params(sh).shape[0] == TT.flat_size(rcfg, tp)
    back = unshard_params(shards, rspecs)
    for p, t in glob.items():
        assert torch.equal(back[p], t), p
    # the port's own init: every rank's shards are those of one global
    # draw
    g = TT.init_params(rcfg, torch.Generator().manual_seed(3), tp=tp)
    for r in (0, tp - 1):
        loc = TT.init_params(rcfg, torch.Generator().manual_seed(3), tp=tp,
                             rank=r)
        want = shard_params(g, rspecs, tp, r)
        assert all(torch.equal(loc[p], want[p]) for p in loc)


# --------------------------------------------------------------------------
# the model: TP / SP / EP against the reference
# --------------------------------------------------------------------------

def _shape(seq=64, batch=4):
    return dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                               global_batch=batch)


def _kv_rep(cfg, tp):
    return max(tp // cfg.n_kv_heads, 1) if cfg.n_heads else 1


def _collapse(glob, cfg, tp):
    """The tp = 1 tree of the same model: the duplicate kv columns and the
    MoE ff slices of the tp global tree joined."""
    out = dict(glob)
    rep = _kv_rep(cfg, tp)
    hd = cfg.head_dim
    e = cfg.n_experts
    slices = tp // e if e and e < tp else 1
    for p, t in glob.items():
        if rep > 1 and p.endswith(("mixer.wk", "mixer.wv")):
            n, d = t.shape[:2]
            out[p] = t.reshape(n, d, cfg.n_kv_heads, rep, hd)[:, :, :, 0] \
                .reshape(n, d, cfg.n_kv_heads * hd).contiguous()
        if slices > 1 and ".ffn." in p and p.endswith(("wg", "wu", "wd")):
            n = t.shape[0]
            if p.endswith("wd"):
                out[p] = t.reshape(n, e, slices * t.shape[2], t.shape[3])
            else:
                out[p] = t.reshape(n, e, slices, t.shape[2], t.shape[3]) \
                    .permute(0, 1, 3, 2, 4).reshape(
                        n, e, t.shape[2], slices * t.shape[3]).contiguous()
    return out


def _expand(grads, cfg, tp):
    """Gradients of the tp = 1 tree in the tp global layout (each kv
    duplicate holds its head's whole gradient, as the group sum gives)."""
    out = dict(grads)
    rep = _kv_rep(cfg, tp)
    hd = cfg.head_dim
    e = cfg.n_experts
    slices = tp // e if e and e < tp else 1
    for p, t in grads.items():
        if rep > 1 and p.endswith(("mixer.wk", "mixer.wv")):
            n, d = t.shape[:2]
            out[p] = t.reshape(n, d, cfg.n_kv_heads, 1, hd).expand(
                n, d, cfg.n_kv_heads, rep, hd).reshape(n, d, -1)
        if slices > 1 and ".ffn." in p and p.endswith(("wg", "wu", "wd")):
            n = t.shape[0]
            if p.endswith("wd"):
                out[p] = t.reshape(n, e * slices, t.shape[2] // slices,
                                   t.shape[3])
            else:
                out[p] = t.reshape(n, e, t.shape[2], slices,
                                   t.shape[3] // slices).permute(
                    0, 1, 3, 2, 4).reshape(n, e * slices, t.shape[2], -1)
    return out


def _case(name, arch, tp, sp=False, seq=32, batch=2, **fields):
    fields.setdefault("capacity_factor", 64.0)
    return name, {"arch": arch, "tp": tp, "sp": sp, "seq": seq,
                  "batch": batch, "fields": fields}


CASES2 = dict([_case(f"tp_{a}", a, 2) for a in PARITY]
              + [_case("tp_bert-large", "bert-large", 2)]
              + [_case(f"sp_{a}", a, 2, sp=True) for a in SP_TOL]
              + [_case("tp_internvl2-2b", "internvl2-2b", 2)])
CASES4 = dict([_case("tp_granite-34b", "granite-34b", 4, seq=32, batch=2),
               _case("ep_slices", "mixtral-8x22b", 4, seq=32, batch=2,
                     n_experts=2)])


_REF_GRAD = jax.value_and_grad(JT.loss_fn, has_aux=True)



def _prepare(workdir, cases, world):
    """The reference's loss and gradients of every TP case (one device,
    ``ParallelCtx()``), and the inputs the ranks take (an SP case takes
    its TP case's)."""
    refs, spec = {}, {}
    for name, c in cases.items():
        data = name.replace("sp_", "tp_", 1)
        spec[name] = {"cfg": dict(arch=c["arch"] + "-smoke", **c["fields"]),
                      "mesh": f"1x{c['tp']}", "sp": c["sp"], "data": data}
        if c["sp"]:
            continue
        jcfg = dataclasses.replace(jget_config(c["arch"]).reduced(),
                                   remat=False, **c["fields"])
        key = jax.random.PRNGKey(0)
        jglob = JT.init_params(jcfg, key, tp=c["tp"])
        batch = make_batch(jcfg, _shape(c["seq"], c["batch"]), key)
        glob = params_from_jax(jglob)
        one = _collapse(glob, jcfg, c["tp"])
        (tot, _), g = _REF_GRAD(_nest(one), batch, jcfg, JCtx())
        refs[name] = (float(tot), _expand(params_from_jax(g), jcfg,
                                          c["tp"]))
        arrays = {f"p:{k}": v.numpy() for k, v in glob.items()}
        arrays.update({f"b:{k}": np.asarray(v) for k, v in batch.items()})
        np.savez(workdir / f"{name}.npz", **arrays)
    with open(workdir / f"cases{world}.json", "w") as f:
        json.dump(spec, f)
    return refs


def _nest(params):
    out = {}
    for path, t in params.items():
        *heads, leaf = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(t.numpy())
    return out


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    out = {}
    for world, cases in ((2, CASES2), (4, CASES4)):
        workdir = tmp_path_factory.mktemp(f"model{world}")
        refs = _prepare(workdir, cases, world)
        _spawn(worker.model_main, world, workdir)
        for name in cases:
            out[name] = (refs.get(name), [np.load(workdir /
                                                  f"{name}_r{r}.npz")
                                          for r in range(world)])
    return out


def _max_rel(cfg, tp, ranks, grads):
    """Worst leaf's max |port - ref| / max |ref| over every rank's
    shards."""
    specs = TT.param_specs(cfg)
    shapes = TT.leaf_shapes(cfg, tp)
    worst = 0.0
    for r, got in enumerate(ranks):
        want = shard_params(grads, specs, tp, r)
        off = 0
        for p, shp in shapes:
            n = math.prod(shp)
            a = want[p].reshape(-1).numpy()
            b = got["grad"][off:off + n]
            off += n
            worst = max(worst, float(np.max(np.abs(a - b)))
                        / (float(np.max(np.abs(a))) + 1e-8))
    return worst


def _cfg(name, cases):
    c = cases[name]
    return dataclasses.replace(get_config(c["arch"] + "-smoke"),
                               **c["fields"]), c["tp"]


ALL = {**CASES2, **CASES4}


@pytest.mark.parametrize("name", [n for n in ALL if not n.startswith("sp_")])
def test_tp_matches_reference(model_runs, name):
    (tot, grads), ranks = model_runs[name]
    cfg, tp = _cfg(name, ALL)
    for got in ranks:
        np.testing.assert_allclose(float(got["total"]), tot, rtol=1e-5)
    err = _max_rel(cfg, tp, ranks, grads)
    assert err < 1e-4, (name, err)


def test_kv_duplicates_bitwise_equal(model_runs):
    """granite-34b at tp = 4: the one kv head on every rank; the group sum
    leaves the four copies' gradients bitwise equal."""
    _, ranks = model_runs["tp_granite-34b"]
    cfg, tp = _cfg("tp_granite-34b", ALL)
    off = 0
    for p, shp in TT.leaf_shapes(cfg, tp):
        n = math.prod(shp)
        if p.endswith(("mixer.wk", "mixer.wv")):
            for got in ranks[1:]:
                np.testing.assert_array_equal(
                    got["grad"][off:off + n], ranks[0]["grad"][off:off + n])
        off += n


@pytest.mark.parametrize("arch", list(SP_TOL))
def test_sp_matches_tp(model_runs, arch):
    """Sequence parallelism against TP.  Dense, SSM and VLM: against the
    reference's loss and gradients of the TP case (the same tp = 2 tree
    and batch) at its TP-parity tolerances.  MoE: against the port's TP
    run at 0.2, since the aux loss over a rank's own tokens differs and a
    reassociated sum can flip a top-k tie."""
    _, sp_ranks = model_runs[f"sp_{arch}"]
    cfg, tp = _cfg(f"sp_{arch}", ALL)
    if not cfg.n_experts:
        tot, grads = model_runs[f"tp_{arch}"][0]
        for got in sp_ranks:
            np.testing.assert_allclose(float(got["total"]), tot, rtol=1e-5)
        err = _max_rel(cfg, tp, sp_ranks, grads)
        assert err < 1e-4, (arch, err)
        return
    _, tp_ranks = model_runs[f"tp_{arch}"]
    for a, b in zip(sp_ranks, tp_ranks):
        assert abs(float(a["total"]) - float(b["total"])) < 1e-3
        ga, gb = a["grad"], b["grad"]
        worst = 0.0
        off = 0
        for _, shp in TT.leaf_shapes(cfg, tp):
            n = math.prod(shp)
            ref = gb[off:off + n]
            worst = max(worst, float(np.max(np.abs(ga[off:off + n] - ref)))
                        / (float(np.max(np.abs(ref))) + 1e-8))
            off += n
        assert worst < SP_TOL[arch], (arch, worst)


@pytest.mark.parametrize("tp", [2, 4])
def test_state_manifest_at_tp_matches_reference(tp, tmp_path):
    """``benchmarks.state_manifest --tp`` against the reference's
    ``layout_manifest`` over the same grid at that tp."""
    path = tmp_path / "m.json"
    TMAN.main(["--tp", str(tp), "--json", str(path)])
    n_inner, n_outer, d, block = TMAN.N_INNER, TMAN.N_OUTER, TMAN.D, \
        TMAN.BLOCK
    n_dp = n_inner * n_outer
    want = {"d": d, "block": block, "grid": {}}
    for layout in ("replicated", "local", "zero1"):
        for topo in ("flat", "hier"):
            n_srv = n_inner if topo == "hier" else n_dp
            ctx = JLayout(d=d, n_dp=n_dp, n_srv=n_srv,
                          n_outer=n_outer if topo == "hier" else 1,
                          n_segments=8, dp_sizes=(n_outer, n_inner), tp=tp)
            want["grid"][f"{layout}/{topo}"] = jlayout_manifest(
                JOpt().state_slots(layout), ctx, block=block)
    assert path.read_text() == json.dumps(want, indent=2,
                                          sort_keys=True) + "\n"
