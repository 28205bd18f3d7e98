"""1-bit Adam over a dp x tp mesh through the port's entry point:
``launch.train.run(mesh="2x2")`` on 4 gloo ranks (2 dp x 2 model ranks),
internlm2-1.8b at smoke size, against the reference on the CPU.

  * each model rank's first compressed exchange, over its own dp group,
    is ``repro.testutils.reference.compressed_allreduce_reference`` of
    the two dp ranks' local momenta and EF slots: the output's sign bits
    (the server payload) bitwise, the output and the new EF slots to f32
    rounding (rtol 1e-6, atol 1e-7: a block's scale is a mean taken in
    another order, and an EF residual of ~1e-10 may change sign with it);
  * the dp replicas of one model rank hold bitwise the same parameters
    and replicated state after the run; the leaves replicated over the
    model axis (norm scales) stay bitwise equal across the model ranks
    through the warmup (the compressed stage, as in the reference,
    exchanges each model rank's own flat vector, whose scale blocks mix
    these leaves with the rank's shards, so there they drift apart by
    the compression's rounding);
  * the loss falls below 0.7 x its start in 30 steps (10 warmup, 20
    compressed; the reference's ``TestDistributedTraining`` bar, there on
    4 dp x 2 tp);
  * ``run(seq_parallel=True)``: its warmup losses within 1e-5 of TP's
    (the reference's SP-vs-TP tolerance for a dense arch);
  * the same dp ranks spelled as a pod axis (``--mesh 2x1x2``: 2 pods of
    1 x 2 model ranks, the flat exchange over both dp axes) train
    bitwise as ``2x2``;
  * ``pipeline=2, overlap_bwd="on"`` (the dp exchange issued from
    backward hooks beside the model group's collectives) bitwise the
    serial pipelined run;
  * on 8 ranks, the hierarchical exchange at ``--mesh 2x2x2`` (2 pods x 2
    x a model axis of 2), serial and overlapped (bitwise), its warmup
    losses against the flat ``4x2`` mesh's to 1e-5;
  * a checkpoint at 2x2 holds the reference's global slot shapes
    (``(*dp_sizes, tp, L)`` per dp rank, ``(tp, L)`` replicated), each
    rank's slots at its (dp, model) row, and the global parameter tree
    (model rank 0's copy of the replicated leaves); a run resumed from a
    checkpoint written at the stage switch (where the replicated leaves
    still agree) is bitwise the uninterrupted one through the compressed
    steps after it.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
mp = pytest.importorskip("torch.multiprocessing")

import jax.numpy as jnp  # noqa: E402

from repro.core.compression import CompressionConfig  # noqa: E402
from repro.testutils.reference import \
    compressed_allreduce_reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

import _torch_tp_worker as worker  # noqa: E402

WORLD, TP, N_DP = 4, 2, 2
ARCH, BLOCK = "internlm2-1.8b-smoke", 512
COMMON = dict(arch=ARCH, mesh="2x2", batch=8, seq=64, block_size=BLOCK,
              lr=2e-3, lr_warmup=0, log_every=1)


def _spawn_runs(workdir, world, spec):
    with open(workdir / f"runs{world}.json", "w") as f:
        json.dump(spec, f)
    mp.start_processes(worker.run_main, args=(world, str(workdir)),
                       nprocs=world, start_method="spawn")
    return {name: [np.load(workdir / f"{name}_r{r}.npz")
                   for r in range(world)] for name in spec}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp_train")
    ckpt = str(workdir / "ck.npz")
    spec = {
        "curve": dict(COMMON, steps=30, warmup_steps=10, record=1),
        "part": dict(COMMON, steps=3, warmup_steps=3, ckpt=ckpt),
        "late": dict(COMMON, steps=5, warmup_steps=3,
                     ckpt=str(workdir / "late.npz")),
        "resumed": dict(COMMON, steps=8, warmup_steps=3, resume=ckpt),
        "whole": dict(COMMON, steps=8, warmup_steps=3),
        "warm": dict(COMMON, steps=3, warmup_steps=3),
        "pods": dict(COMMON, mesh="2x1x2", steps=5, warmup_steps=3),
        "sp": dict(COMMON, steps=5, warmup_steps=3, seq_parallel=True),
        "pipe": dict(COMMON, steps=5, warmup_steps=3, pipeline=2,
                     overlap_bwd="off"),
        "pipe_overlap": dict(COMMON, steps=5, warmup_steps=3, pipeline=2,
                             overlap_bwd="on"),
    }
    out = _spawn_runs(workdir, WORLD, spec)
    return out, np.load(ckpt), np.load(workdir / "late.npz")


@pytest.fixture(scope="module")
def runs8(tmp_path_factory):
    """Eight ranks: 2 pods x 2 x a model axis of 2 under the hierarchical
    exchange (serial, and pipelined with backward overlap), and the same
    ranks as a flat 4 x 2 mesh."""
    workdir = tmp_path_factory.mktemp("tp_train8")
    base = dict(COMMON, steps=5, warmup_steps=3, topology="hier")
    spec = {"hier": dict(base, mesh="2x2x2", pipeline=2, overlap_bwd="off"),
            "hier_overlap": dict(base, mesh="2x2x2", pipeline=2,
                                 overlap_bwd="on"),
            "flat8": dict(base, mesh="4x2", topology="flat")}
    return _spawn_runs(workdir, 8, spec)


def _ranks_of_model(m):
    """Global ranks of model rank ``m``, in dp order."""
    return [i * TP + m for i in range(N_DP)]


@pytest.mark.parametrize("m", range(TP))
def test_first_exchange_is_the_oracle(runs, m):
    out = runs[0]
    recs = [out["curve"][r] for r in _ranks_of_model(m)]
    xs = [jnp.asarray(r["rec0_m"]) for r in recs]
    werrs = [jnp.asarray(r["rec0_worker_in"]) for r in recs]
    serr = jnp.concatenate([jnp.asarray(r["rec0_server_in"]) for r in recs])
    jout, jwerrs, jserr = compressed_allreduce_reference(
        xs, werrs, serr, CompressionConfig(block_size=BLOCK))
    jout, jserr = np.asarray(jout), np.asarray(jserr)
    chunk = jserr.shape[0] // N_DP
    assert xs[0].shape[0] == recs[0]["d_pad"]
    for i, r in enumerate(recs):
        pairs = ((r["rec0_out"], jout),
                 (r["rec0_worker_out"], np.asarray(jwerrs[i])),
                 (r["rec0_server_out"], jserr[i * chunk:(i + 1) * chunk]))
        np.testing.assert_array_equal(np.signbit(r["rec0_out"]),
                                      np.signbit(jout))
        for got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_model_ranks_hold_their_own_shards(runs):
    out = runs[0]
    cfg = get_config(ARCH)
    d = TT.flat_size(cfg, TP)
    ranks = out["curve"]
    assert d < TT.flat_size(cfg, 1)
    # the replicas of one model rank agree bitwise; the model ranks differ
    for m in range(TP):
        a, b = (ranks[r] for r in _ranks_of_model(m))
        np.testing.assert_array_equal(a["x"], b["x"])
        for k in ("opt_m", "opt_v", "opt_scale", "opt_count"):
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(ranks[0]["x"][:d], ranks[1]["x"][:d])
    # through the warmup the replicated leaves (norm scales) agree across
    # the model ranks too
    warm = out["warm"]
    off, seen = 0, 0
    for path, shp in TT.leaf_shapes(cfg, TP):
        n = int(np.prod(shp))
        if TT.param_specs(cfg)[path] is None:
            seen += 1
            for r in warm[1:]:
                np.testing.assert_array_equal(r["x"][off:off + n],
                                              warm[0]["x"][off:off + n])
        off += n
    assert seen == 3 and warm[0]["x"][:d].std() > 0


def test_loss_falls(runs):
    out = runs[0]
    losses = out["curve"][0]["losses"]
    assert len(losses) == 30
    assert losses[-1] < 0.7 * losses[0], losses
    for r in out["curve"][1:]:
        np.testing.assert_array_equal(r["losses"], losses)


def test_checkpoint_layout(runs):
    out, _, ck = runs
    late = out["late"]
    d_pad = int(late[0]["d_pad"])
    assert ck["1|.m"].shape == (TP, d_pad)                 # replicated
    assert ck["1|.worker_err"].shape == (N_DP, TP, d_pad)  # per dp rank
    assert ck["1|.server_err"].shape == (N_DP, TP, d_pad // N_DP)
    for r, got in enumerate(late):
        i, m = divmod(r, TP)
        for k in ("worker_err", "server_err"):
            assert np.abs(got[f"opt_{k}"]).max() > 0
            np.testing.assert_array_equal(ck[f"1|.{k}"][i, m],
                                          got[f"opt_{k}"])
        np.testing.assert_array_equal(ck["1|.m"][m], got["opt_m"])
    cfg = get_config(ARCH)
    glob = dict(TT.global_leaf_shapes(cfg, TP))
    params = {k.split("|", 1)[1].replace("|", "."): ck[k]
              for k in ck.files if k.startswith("0|")}
    assert {p: a.shape for p, a in params.items()} == glob
    specs = TT.param_specs(cfg)
    for m in range(TP):
        off = 0
        for path, shp in TT.leaf_shapes(cfg, TP):
            n = int(np.prod(shp))
            dim = specs[path]
            want = params[path]
            if dim is not None:
                size = want.shape[dim] // TP
                want = np.take(want, range(m * size, (m + 1) * size),
                               axis=dim)
            elif m:
                off += n
                continue            # model rank 0's copy
            np.testing.assert_array_equal(
                late[m]["x"][off:off + n].reshape(shp), want)
            off += n


def test_resume_is_bitwise(runs):
    out = runs[0]
    for a, b in zip(out["resumed"], out["whole"]):
        np.testing.assert_array_equal(a["x"], b["x"])
        for k in a.files:
            if k.startswith("opt_"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["losses"], b["losses"][3:])


def test_pod_mesh_is_the_dp_mesh(runs):
    out = runs[0]
    for a, b in zip(out["pods"], out["late"]):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["opt_server_err"],
                                      b["opt_server_err"])


def test_seq_parallel_run_matches_tp(runs):
    out = runs[0]
    for a, b in zip(out["sp"], out["late"]):
        np.testing.assert_allclose(a["losses"][:4], b["losses"][:4],
                                   rtol=1e-5)
        assert np.isfinite(a["losses"]).all()


def _assert_bitwise(runs_a, runs_b):
    for a, b in zip(runs_a, runs_b):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["x"], b["x"])
        for k in a.files:
            if k.startswith("opt_"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_overlap_is_bitwise_serial(runs):
    """``pipeline=2, overlap_bwd="on"`` at 2 x 2: the dp exchange's buckets
    issue from backward hooks between the model group's collectives, and
    every rank's losses, parameters and state are bitwise the serial
    pipelined run's."""
    out = runs[0]
    for a, b in zip(out["pipe_overlap"], out["pipe"]):
        assert int(a["n_buckets"]) == int(b["n_buckets"]) == 2
        assert bool(a["overlap_bwd"]) and not bool(b["overlap_bwd"])
    _assert_bitwise(out["pipe_overlap"], out["pipe"])
    for r in out["pipe"]:
        assert np.isfinite(r["losses"]).all()


def test_hier_at_tp(runs8):
    """The hierarchical exchange on 2 pods x 2 x a model axis of 2: each
    model rank's exchange runs over its own pod and data groups.  The
    warmup losses (an uncompressed all-reduce, summed in another order)
    are those of the flat 4 x 2 mesh over the same ranks to 1e-5; the dp
    replicas of every model rank end bitwise equal; backward overlap is
    bitwise the serial run."""
    hier, flat = runs8["hier"], runs8["flat8"]
    for a, b in zip(runs8["hier_overlap"], hier):
        assert str(a["topology"]) == str(b["topology"]) == "hier"
        assert int(a["n_buckets"]) == 2 and bool(a["overlap_bwd"])
    _assert_bitwise(runs8["hier_overlap"], hier)
    for a, b in zip(hier, flat):
        np.testing.assert_allclose(a["losses"][:4], b["losses"][:4],
                                   rtol=1e-5)
        assert np.isfinite(a["losses"]).all()
    for m in range(TP):
        xs = [hier[i * TP + m]["x"] for i in range(4)]
        for x in xs[1:]:
            np.testing.assert_array_equal(x, xs[0])
    assert not np.array_equal(hier[0]["x"], hier[1]["x"])
