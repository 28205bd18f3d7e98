"""The hierarchical two-level exchange of the port against the JAX package.

Four gloo ranks as 2 pods x 2 (``repro_torch.launch.mesh.build_mesh
("2x2x1")``, a ``DeviceMesh`` whose "pod" and "data" groups carry the
cross-pod and intra-pod legs), three chained exchanges from zero EF slots
per compressor: ``onebit`` (EF-free cross-pod legs), ``topk`` (the
``outer`` / ``outer_ag`` EF slots) and ``identity`` (a cross-pod
all-reduce), serial and over 3 buckets.  The reference runs
``repro.core.comm.compressed_exchange`` with ``pod_axes`` on the same
numpy inputs inside ``shard_map`` on a (2, 2) mesh of forced host
devices, once per module in a subprocess.

  * rank for rank against the reference, serial and pipelined: top-k and
    identity bitwise (copies, and sums of two in the same order); 1-bit
    at ``tests/test_torch_exchange.py``'s tolerances, rtol 1e-5 / atol
    1e-6 (the block means sum in another order than XLA's);
  * the port's pipelined exchange bitwise its serial one: outputs, the
    worker slot, and the chunk slots once keyed canonically
    (``repro_torch.state.ef_slot_perm``: which elements a rank serves
    depends on the bucket partition, so a slot view off by its stride
    shows here);
  * top-k on hier without the outer slots raises ``ValueError``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import _torch_hier_worker as worker  # noqa: E402
from repro_torch.state import ef_slot_perm  # noqa: E402
from repro_torch.pipeline import Bucketer  # noqa: E402

BLOCK = 64
N_IN, N_OUT = 2, 2
N = N_IN * N_OUT
D = 7 * N * BLOCK              # 7 alignment units: 3 uneven buckets
REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SLOTS = ("worker", "server", "outer", "outer_ag")

REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.comm import compressed_exchange
from repro.launch.mesh import make_mesh
from repro.optim import get_compressor

workdir, block, nb_pipe, steps = sys.argv[1], int(sys.argv[2]), \\
    int(sys.argv[3]), int(sys.argv[4])
xs = np.load(workdir + "/inputs.npz")["xs"]
d = xs.shape[-1]
mesh = make_mesh((2, 2), ("pod", "data"))
out = {}
for name in ("onebit", "topk", "identity"):
    comp = get_compressor(name, block_size=block)
    for nb in (1, nb_pipe):
        errs = {"worker": np.zeros((2, 2, d), np.float32),
                "server": np.zeros((2, 2, d // 2), np.float32),
                "outer": np.zeros((2, 2, d // 2), np.float32),
                "outer_ag": np.zeros((2, 2, d // 4), np.float32)}
        spec = {k: P("pod", "data", None) for k in errs}

        def body(x, e, nb=nb, comp=comp):
            e1 = {k: v[0, 0] for k, v in e.items()}
            m, ne = compressed_exchange(x[0, 0], e1, ("data",), ("pod",),
                                        comp, n_buckets=nb)
            return m[None, None], {k: v[None, None] for k, v in ne.items()}

        f = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("pod", "data", None), spec),
            out_specs=(P("pod", "data", None), spec), check_vma=False))
        errs = {k: jnp.asarray(v) for k, v in errs.items()}
        for step in range(steps):
            m, errs = f(jnp.asarray(xs[step].reshape(2, 2, d)), errs)
            key = f"{name}_nb{nb}_s{step}"
            out[key + "_out"] = np.asarray(m).reshape(4, -1)
            for k, v in errs.items():
                out[f"{key}_{k}"] = np.asarray(v).reshape(4, -1)
np.savez(workdir + "/reference.npz", **out)
print("OK")
"""


def _reference(workdir):
    env = dict(os.environ, PYTHONPATH=REPO_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(workdir),
         str(BLOCK), str(worker.NB), str(worker.EXCHANGE_STEPS)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return np.load(os.path.join(workdir, "reference.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("hier")
    rng = np.random.default_rng(21)
    xs = rng.standard_normal((worker.EXCHANGE_STEPS, N, D)).astype(
        np.float32)
    np.savez(workdir / "inputs.npz", xs=xs)
    mp.start_processes(worker.exchange_main,
                       args=(N, str(workdir), BLOCK, "gloo"), nprocs=N,
                       start_method="spawn")
    ranks = [np.load(workdir / f"gloo{r}.npz") for r in range(N)]
    return ranks, _reference(workdir)


CASES = [(c, nb) for c in worker.COMPRESSORS for nb in (1, worker.NB)]


@pytest.mark.parametrize("comp,nb", CASES)
def test_hier_exchange_matches_reference(runs, comp, nb):
    ranks, ref = runs
    for step in range(worker.EXCHANGE_STEPS):
        key = f"{comp}_nb{nb}_s{step}"
        for r, got in enumerate(ranks):
            for k in ("out",) + SLOTS:
                want = ref[f"{key}_{k}"][r]
                if comp == "onebit":
                    np.testing.assert_allclose(got[f"{key}_{k}"], want,
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=f"{key}_{k} r{r}")
                else:
                    np.testing.assert_array_equal(got[f"{key}_{k}"], want,
                                                  err_msg=f"{key}_{k} r{r}")


def _canonical(slot_by_rank, slot, sizes):
    """Every rank's chunk slot (rank order = pod * 2 + data) permuted into
    the canonical (serial) keying."""
    a = np.stack(slot_by_rank)                       # (4, L)
    if slot == "outer_ag":       # served by all 4 ranks: (n_sub=pod, srv)
        perm = ef_slot_perm(D, sizes, N_IN, N_OUT)
        return a.reshape(-1)[perm].reshape(a.shape)
    perm = ef_slot_perm(D, sizes, N_IN, 1)           # per pod replica
    return np.stack([a[p * N_IN:(p + 1) * N_IN].reshape(-1)[perm]
                     .reshape(N_IN, -1) for p in range(N_OUT)]
                    ).reshape(a.shape)


@pytest.mark.parametrize("comp", worker.COMPRESSORS)
def test_pipelined_hier_bitwise_serial(runs, comp):
    ranks, _ = runs
    sizes = Bucketer.for_exchange(D, N, BLOCK, worker.NB).sizes
    assert len(sizes) == worker.NB and len(set(sizes)) == 2
    for step in range(worker.EXCHANGE_STEPS):
        ser, pip = f"{comp}_nb1_s{step}", f"{comp}_nb{worker.NB}_s{step}"
        for got in ranks:
            np.testing.assert_array_equal(got[pip + "_out"],
                                          got[ser + "_out"])
            np.testing.assert_array_equal(got[pip + "_worker"],
                                          got[ser + "_worker"])
        for slot in ("server", "outer", "outer_ag"):
            want = np.stack([g[f"{ser}_{slot}"] for g in ranks])
            got = _canonical([g[f"{pip}_{slot}"] for g in ranks], slot,
                             sizes)
            np.testing.assert_array_equal(got, want, err_msg=slot)
        if comp == "topk" and step:
            # the cross-pod EF slots carry residuals (sparse compressor)
            assert np.abs(want).sum() > 0


def test_every_rank_holds_the_same_result(runs):
    ranks, _ = runs
    for key in ranks[0].files:
        if key.endswith("_out"):
            for got in ranks[1:]:
                np.testing.assert_array_equal(got[key], ranks[0][key])


def test_topk_on_hier_needs_outer_slots(runs):
    ranks, _ = runs
    assert all(bool(g["topk_no_outer_raised"]) for g in ranks)


def test_mesh_spelling():
    from repro_torch.launch.mesh import mesh_axes, parse_mesh, pod_split
    assert parse_mesh("4") == ((4,), 1) and parse_mesh("4x1") == ((4,), 1)
    assert parse_mesh("2x2x1") == ((2, 2), 1)
    assert mesh_axes((2, 2)) == ("pod", "data")
    assert pod_split(("pod", "data"), (2, 4)) == (("data",), ("pod",), 4, 2)
    assert pod_split(("dp",), (4,)) == (("dp",), (), 4, 1)
    assert parse_mesh("2x2x2") == ((2, 2), 2)
    assert parse_mesh("2x4") == ((2,), 4)
    with pytest.raises(ValueError):
        parse_mesh("2x2x2x2")
    assert parse_mesh((2, 2, 1)) == ((2, 2), 1)
