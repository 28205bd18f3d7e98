"""The port's compressed exchange against the JAX reference.

Single rank: ``repro_torch.core.comm.compressed_allreduce`` with no axis
against ``repro.core.comm.compressed_allreduce`` with no axis (both keep
the compress/decompress round trip).  2 and 4 gloo ranks, each test with
its own ``file://`` rendezvous under ``tmp_path``: held rank for rank
against ``repro.testutils.reference.compressed_allreduce_reference``.

The sign bits on the wire are bitwise the reference's.  Scales are block
means summed in another order than XLA's, so they, the averaged output
(+-scale) and the residuals agree to rtol 1e-6 / 1e-5 (tests/test_kernels.py
tolerances), with atol 1e-6 on the residuals.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import _torch_exchange_worker as worker  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core.compression import (  # noqa: E402
    CompressionConfig, ef_compress, pack_signs)
from repro.optim.compressors import \
    OneBitCompressor as JOneBit  # noqa: E402
from repro.testutils.reference import \
    compressed_allreduce_reference  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.optim.compressors import IdentityCompressor  # noqa: E402

BLOCK = 256


def _inputs(seed, n, nblocks_per_rank=3):
    rng = np.random.default_rng(seed)
    d = n * nblocks_per_rank * BLOCK
    xs = rng.standard_normal((n, d)).astype(np.float32)
    werrs = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    serrs = (rng.standard_normal((n, d // n)) * 0.1).astype(np.float32)
    return xs, werrs, serrs


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_rank_matches_reference(seed):
    xs, werrs, serrs = _inputs(seed, 1)
    comp = worker.RecordingCompressor(BLOCK)
    out, werr, serr = tcomm.compressed_allreduce(
        torch.from_numpy(xs[0]), torch.from_numpy(werrs[0]),
        torch.from_numpy(serrs[0]), (), comp)
    jout, jwerr, jserr = jcomm.compressed_allreduce(
        jnp.asarray(xs[0]), jnp.asarray(werrs[0]), jnp.asarray(serrs[0]),
        (), JOneBit(block_size=BLOCK))
    _close(out.numpy(), jout)
    _close(werr.numpy(), jwerr)
    _close(serr.numpy(), jserr)
    (wpk, wsc), (spk, _) = comp.payloads
    (jpk, jsc), _ = ef_compress(jnp.asarray(xs[0]), jnp.asarray(werrs[0]),
                                CompressionConfig(block_size=BLOCK))
    np.testing.assert_array_equal(wpk.numpy(), np.asarray(jpk))
    _close(wsc.numpy(), jsc, rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(spk.numpy(),
                                  np.asarray(pack_signs(jout)))


def test_identity_exchange_is_the_mean():
    xs, werrs, serrs = _inputs(2, 1)
    out, werr, _ = tcomm.compressed_allreduce(
        torch.from_numpy(xs[0]), torch.from_numpy(werrs[0]),
        torch.from_numpy(serrs[0]), (), IdentityCompressor())
    np.testing.assert_array_equal(out.numpy(), xs[0] + werrs[0] + serrs[0])
    assert not werr.any()


def test_allreduce_mean_without_axis_is_identity():
    x = torch.arange(8, dtype=torch.float32)
    assert tcomm.allreduce_mean(x, ()) is x
    assert tcomm.axis_size(()) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ranks_match_reference(n, tmp_path):
    xs, werrs, serrs = _inputs(10 + n, n)
    np.savez(tmp_path / "inputs.npz", xs=xs, werrs=werrs, serrs=serrs)
    mp.start_processes(worker.rank_main, args=(n, str(tmp_path), BLOCK),
                       nprocs=n, start_method="spawn", join=True)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]

    cfg = CompressionConfig(block_size=BLOCK)
    jout, jwerrs, jserr = compressed_allreduce_reference(
        [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in werrs],
        jnp.asarray(serrs.reshape(-1)), cfg)
    jout, jserr = np.asarray(jout), np.asarray(jserr)
    chunk = xs.shape[1] // n
    for r, res in enumerate(ranks):
        # every rank holds the same averaged vector, the reference's
        _close(res["out"], jout)
        _close(res["werr"], jwerrs[r])
        _close(res["serr"], jserr[r * chunk:(r + 1) * chunk])
        # wire bytes: the worker payload is the reference's EF-compress of
        # this rank's input; the server payload's signs are those of the
        # reference's output chunk this rank serves
        (jpk, jsc), _ = ef_compress(jnp.asarray(xs[r]),
                                    jnp.asarray(werrs[r]), cfg)
        np.testing.assert_array_equal(res["wpk"], np.asarray(jpk))
        _close(res["wsc"], jsc, rtol=1e-6, atol=0.0)
        mine = jout[r * chunk:(r + 1) * chunk]
        np.testing.assert_array_equal(res["spk"],
                                      np.asarray(pack_signs(mine)))
        _close(res["ssc"], np.abs(mine.reshape(-1, BLOCK))[:, 0], rtol=1e-6,
               atol=0.0)


def test_two_rank_training_keeps_replicas_identical(tmp_path):
    """``run`` on 2 gloo ranks: each rank trains on its own shard of the
    batch, and the only dp communication is the optimizer's exchange, so
    the replicated parameters stay bitwise identical across ranks through
    the warmup all-reduce and the compressed exchange, and the dp-meaned
    metrics agree."""
    mp.start_processes(worker.train_main, args=(2, str(tmp_path)),
                       nprocs=2, start_method="spawn", join=True)
    r0, r1 = (np.load(tmp_path / f"train{r}.npz") for r in range(2))
    assert list(r0["stage"]) == ["warmup"] * 2 + ["compressed"] * 2
    assert int(r0["d_pad"]) % (2 * 512) == 0
    assert np.isfinite(r0["loss"]).all()
    np.testing.assert_array_equal(r0["x"], r1["x"])
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    np.testing.assert_array_equal(r0["v_l1"], r1["v_l1"])
    assert r0["v_l1"][1] == r0["v_l1"][2] == r0["v_l1"][3]   # v frozen
