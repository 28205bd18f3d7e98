"""The port's functional oracles (``repro_torch.core.{adam,momentum,
onebit_adam}``) and the config bridge against the JAX package.

Same numpy inputs on both sides.  ``core.adam.update``: 10 steps against
``repro.core.adam`` at rtol 1e-6 / atol 1e-7.  The momentum SGD variants,
naive compressed Adam and 1-bit Adam (5 warmup + 5 compressed steps, then
3 ZeRO-1 compressed steps from the warmup's state) at d = 4 x 4096 x 2 on
one rank in process and on 2 gloo ranks (``file://`` rendezvous under
``tmp_path``), against the reference inside ``shard_map`` on a mesh of 2
forced host devices in a subprocess (one rank: no axes, in the same
subprocess):

  * every payload the exchange put on the wire is the reference's
    ``ef_compress`` of the same inputs: sign bits and identity buffers
    bitwise, scales at rtol 1e-6 (block means summed in another order);
  * state, parameters and stats at rtol 1e-6 / atol 1e-5, as
    tests/test_torch_exchange.py holds ``compressed_allreduce`` (the
    scale sums propagate into the averaged momentum at the ULP);
  * ZeRO-1: the f32 master chunk at the same tolerance, the bf16 replica
    within one bf16 ulp (a master value that moved by an f32 ulp can
    round to the neighbouring bf16 value).

Also the reference's own equivalences held in the port
(``tests/test_optim.py``'s ``TestOneBitAdamEquivalences``), the
``hierarchical`` branch (``NotImplementedError`` with ``pod_axes``; the
flat path without), and ``train.step.optimizer_from_config`` against
``tests/test_optim_registry.py``'s legacy-config test.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import _torch_oracle_worker as worker  # noqa: E402
from repro.core import adam as JA  # noqa: E402
from repro.core.compression import (CompressionConfig as JCompression,  # noqa: E402
                                    ef_compress as jef_compress)
from repro_torch.core import adam as TA  # noqa: E402
from repro_torch.core import onebit_adam as OB  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL, ATOL = 1e-6, 1e-5

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import momentum as M, onebit_adam as OB
from repro.core.compression import CompressionConfig
from repro.launch.mesh import make_mesh

workdir = sys.argv[1]
BLOCK, D, MSGD_STEPS, WARMUP, STEPS, ZERO1 = (int(a) for a in sys.argv[2:8])
LR, MSGD_LR = float(sys.argv[8]), float(sys.argv[9])
data = np.load(workdir + "/inputs.npz")
onebit = CompressionConfig(block_size=BLOCK)


def cases(grads, x0, axes, rank_index, n):
    # grads: (steps, d) of this rank; returns {key: array}
    out = {}

    def save(key, x, st, stats=None):
        out[key + "_x"] = x
        for f, v in st._asdict().items():
            out[f"{key}_{f}"] = v
        for k, v in (stats or {}).items():
            out[f"{key}_stat_{k}"] = v

    for kind, comp in (("identity", CompressionConfig(kind="identity")),
                       ("onebit", onebit)):
        cfg = M.MomentumConfig(compression=comp)
        x, st = x0, M.init(D, n)
        for t in range(MSGD_STEPS):
            x, st = M.update(grads[t], st, x, cfg, jnp.float32(MSGD_LR),
                             axes)
            save(f"msgd_{kind}_s{t}", x, st)
    x, st = x0, M.naive_init(D, n)
    for t in range(MSGD_STEPS):
        x, st = M.naive_compressed_adam_update(
            grads[t], st, x, 0.9, 0.999, 1e-8, jnp.float32(LR), onebit, axes)
        save(f"naive_s{t}", x, st)
    cfg = OB.OneBitAdamConfig(compression=onebit)
    x, st = x0, OB.init(D, n)
    for t in range(STEPS):
        step = OB.warmup_update if t < WARMUP else OB.compressed_update
        x, st, stats = step(grads[t], st, x, cfg, jnp.float32(LR), axes)
        save(f"ob_s{t}", x, st, stats)
        if t == WARMUP - 1:
            warm = (x, st)
    x, st = warm
    chunk = D // n
    lo = rank_index() * chunk
    z = OB.ZeroOneBitAdamState(
        m=st.m, v_shard=jax.lax.dynamic_slice(st.v, (lo,), (chunk,)),
        master_shard=jax.lax.dynamic_slice(x, (lo,), (chunk,)),
        worker_err=st.worker_err, server_err=st.server_err, count=st.count)
    for t in range(ZERO1):
        x_full, z, stats = OB.zero1_compressed_update(
            grads[WARMUP + t], z, cfg, jnp.float32(LR), axes)
        save(f"zero1_s{t}", jax.lax.bitcast_convert_type(x_full, jnp.int16),
             z, stats)
    return out


g_all, x0 = jnp.asarray(data["grads"]), jnp.asarray(data["x0"])
one = cases(g_all[:, 0], x0, (), lambda: 0, 1)
np.savez(workdir + "/ref_n1.npz",
         **{k: np.asarray(v)[None] for k, v in one.items()})
n = g_all.shape[1]
mesh = make_mesh((n,), ("data",))


def body(g):
    res = cases(g[:, 0], x0, ("data",),
                lambda: jax.lax.axis_index("data"), n)
    return {k: v[None] for k, v in res.items()}


f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P(None, "data"),
                          out_specs=P("data"), check_vma=False))
np.savez(workdir + f"/ref_n{n}.npz",
         **{k: np.asarray(v) for k, v in f(g_all).items()})
print("OK")
"""


def _inputs(n):
    rng = np.random.default_rng(16)
    return {"grads": (rng.standard_normal((worker.STEPS, n, worker.D))
                      * 0.01).astype(np.float32),
            "x0": (rng.standard_normal(worker.D) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (per-rank port results, reference results)} for n = 1, 2."""
    workdir = tmp_path_factory.mktemp("oracles")
    n = 2
    np.savez(workdir / "inputs.npz", **_inputs(n))
    env = dict(os.environ, PYTHONPATH=REPO_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    args = [str(a) for a in (worker.BLOCK, worker.D, worker.MSGD_STEPS,
                             worker.WARMUP, worker.STEPS, worker.ZERO1,
                             worker.LR, worker.MSGD_LR)]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(workdir)]
        + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    try:
        data = np.load(workdir / "inputs.npz")
        port = {1: [worker.run_cases(data, 0, 1, (), torch.device("cpu"))]}
        mp.start_processes(worker.oracle_main, args=(n, str(workdir)),
                           nprocs=n, start_method="spawn")
        port[n] = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(n)]
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return {k: (port[k], np.load(workdir / f"ref_n{k}.npz"))
            for k in (1, n)}


def _steps(case):
    if case == "ob":
        return worker.STEPS
    if case == "zero1":
        return worker.ZERO1
    return worker.MSGD_STEPS


CASES = ["msgd_identity", "msgd_onebit", "naive", "ob", "zero1"]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_state_matches_reference(runs, case, n):
    ranks, ref = runs[n]
    for t in range(_steps(case)):
        key = f"{case}_s{t}_"
        names = [k[len(key):] for k in ref.files if k.startswith(key)]
        assert "x" in names and "count" in names, names
        for r, got in enumerate(ranks):
            for name in names:
                a, b = got[key + name], ref[key + name][r]
                msg = f"{key}{name} rank {r}"
                if case == "zero1" and name == "x":
                    _within_bf16_ulp(a, b, msg)
                elif name == "count":
                    np.testing.assert_array_equal(a, b, err_msg=msg)
                else:
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                               err_msg=msg)


def _within_bf16_ulp(a_bits, b_bits, msg):
    """Two bf16 vectors given as their int16 bits differ by at most one
    bf16 ulp."""
    a = torch.from_numpy(a_bits).view(torch.bfloat16).float()
    b = torch.from_numpy(b_bits).view(torch.bfloat16).float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, 2.0 ** (torch.floor(torch.log2(mag)) - 7),
                      torch.zeros_like(mag))
    bad = (a - b).abs() > ulp
    assert not bool(bad.any()), f"{msg}: {int(bad.sum())} values beyond " \
        "one bf16 ulp"


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_wire_payloads_are_the_references(runs, case, n):
    """Each EF-compress of the exchange (the worker's, then the server's)
    put on the wire the reference's ``ef_compress`` of the same inputs."""
    ranks, _ = runs[n]
    kind = "identity" if case == "msgd_identity" else "onebit"
    cfg = JCompression(kind=kind, block_size=worker.BLOCK)
    seen = 0
    for got in ranks:
        for t in range(_steps(case)):
            for who in "ws":
                key = f"{case}_s{t}_{who}"
                if key + "in" not in got:
                    continue            # a warmup step exchanges no payload
                (p0, p1), _ = jef_compress(jnp.asarray(got[key + "in"]),
                                           jnp.asarray(got[key + "err_in"]),
                                           cfg)
                np.testing.assert_array_equal(got[key + "p0"],
                                              np.asarray(p0))
                if kind == "onebit":
                    np.testing.assert_allclose(got[key + "p1"],
                                               np.asarray(p1), rtol=1e-6,
                                               atol=0.0)
                seen += 1
    assert seen == 2 * n * (_steps(case) - (worker.WARMUP if case == "ob"
                                            else 0))


@pytest.mark.parametrize("bias_correction", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_reference(bias_correction, wd):
    rng = np.random.default_rng(3)
    d = 4096
    x = (rng.standard_normal(d) * 0.05).astype(np.float32)
    jcfg = JA.AdamConfig(weight_decay=wd, bias_correction=bias_correction)
    tcfg = TA.AdamConfig(weight_decay=wd, bias_correction=bias_correction)
    jx, jst = jnp.asarray(x), JA.init(d)
    tx, tst = torch.from_numpy(x), TA.init(d, device="cpu")
    for _ in range(10):
        g = (rng.standard_normal(d) * 0.01).astype(np.float32)
        jx, jst = JA.update(jnp.asarray(g), jst, jx, jcfg, jnp.float32(1e-2))
        tx, tst = TA.update(torch.from_numpy(g), tst, tx, tcfg, 1e-2)
        for a, b in ((tx, jx), (tst.m, jst.m), (tst.v, jst.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert int(tst.count) == int(jst.count)


def _quad(seed, d=256):
    """The quadratic of tests/test_optim.py: grad = a * (x - t) + noise."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, d).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    gen = torch.Generator().manual_seed(seed)
    return lambda x: a * (x - t) + 0.1 * torch.randn(d, generator=gen)


def test_warmup_equals_adam():
    """The warmup stage is bitwise baseline Adam."""
    d = 256
    grad = _quad(1, d)
    x1 = x2 = torch.zeros(d)
    st1, st2 = OB.init(d, 1, device="cpu"), TA.init(d, device="cpu")
    for _ in range(20):
        g = grad(x1)
        x1, st1, _ = OB.warmup_update(g, st1, x1, OB.OneBitAdamConfig(),
                                      1e-2)
        x2, st2 = TA.update(g, st2, x2, TA.AdamConfig(), 1e-2)
        assert torch.equal(x1, x2)
    assert torch.equal(st1.v, st2.v)


def test_identity_compression_is_preconditioned_momentum_sgd():
    """Identity compression on one rank: the compression stage is momentum
    SGD with the frozen-v coordinate-wise LR."""
    d = 256
    cfg = OB.OneBitAdamConfig(compression=CompressionConfig(kind="identity"))
    v = torch.sin(torch.arange(d, dtype=torch.float32)).abs() + 0.5
    st = OB.init(d, 1, device="cpu")._replace(v=v)
    x, m_ref = torch.ones(d), torch.zeros(d)
    grad = _quad(2, d)
    for _ in range(10):
        g = grad(x)
        x_new, st, _ = OB.compressed_update(g, st, x, cfg, 1e-2)
        m_ref = 0.9 * m_ref + 0.1 * g
        x_ref = x - 1e-2 * m_ref / (torch.sqrt(v) + cfg.eps)
        np.testing.assert_allclose(x_new.numpy(), x_ref.numpy(), rtol=1e-6,
                                   atol=1e-7)
        x = x_new


def test_v_frozen_in_compression_stage():
    d = 1024
    cfg = OB.OneBitAdamConfig(compression=CompressionConfig(block_size=256))
    st = OB.init(d, 1, device="cpu")._replace(v=torch.ones(d))
    x = torch.ones(d)
    _, st2, stats = OB.compressed_update(_quad(3, d)(x), st, x, cfg, 1e-2)
    assert torch.equal(st2.v, st.v)
    assert set(stats) == {"v_l1", "momentum_norm", "worker_err_norm",
                          "server_err_norm"}


def test_hierarchical_raises_with_pod_axes_and_is_flat_without():
    d = 2048
    flat = OB.OneBitAdamConfig(compression=CompressionConfig(block_size=256))
    hier = OB.OneBitAdamConfig(compression=CompressionConfig(block_size=256),
                               hierarchical=True)
    g = _quad(4, d)(torch.zeros(d))
    st = OB.init(d, 1, device="cpu")._replace(
        v=torch.full((d,), 0.5))
    x = torch.ones(d)
    with pytest.raises(NotImplementedError,
                       match=r"src/repro/core/onebit_adam\.py:108"):
        OB.compressed_update(g, st, x, hier, 1e-2, dp_axes=("data",),
                             pod_axes=("pod",))
    a = OB.compressed_update(g, st, x, flat, 1e-2)
    b = OB.compressed_update(g, st, x, hier, 1e-2)
    assert torch.equal(a[0], b[0])
    for u, w in zip(a[1], b[1]):
        assert torch.equal(u, w)


def test_config_bridge_builds_onebit_adam():
    """``optimizer_from_config`` against the reference's
    ``TrainStepConfig(opt=...).build_optimizer()``
    (tests/test_optim_registry.py's legacy-config test), field for
    field."""
    from repro.core import onebit_adam as JOB
    from repro.train.step import TrainStepConfig
    from repro_torch.train.step import optimizer_from_config
    for kw in (dict(b1=0.8), dict(b2=0.97, eps=1e-6, weight_decay=0.01,
                                  bias_correction=True)):
        for kind in ("onebit", "identity"):
            want = TrainStepConfig(opt=JOB.OneBitAdamConfig(
                compression=JCompression(kind=kind, block_size=512), **kw)
            ).build_optimizer()
            got = optimizer_from_config(OB.OneBitAdamConfig(
                compression=CompressionConfig(kind=kind, block_size=512),
                **kw))
            assert got.name == want.name == "onebit_adam"
            for f in ("b1", "b2", "eps", "weight_decay", "bias_correction"):
                assert getattr(got, f) == getattr(want, f), f
            assert got.compressor.name == want.compressor.name == kind
            assert got.compressor.block_size == want.compressor.block_size
