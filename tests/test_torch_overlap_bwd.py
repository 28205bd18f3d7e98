"""``overlap_check --bwd`` and the backward-overlap front end of the port,
on the CPU, against the JAX package:

  * ``check_bwd_trace`` on made-up Kineto event lists, the reference's
    three HLO cases of ``tests/test_overlap_bwd.py`` (a collective issued
    between two matmuls counts, with ``dots_after == 1``; one issued after
    every matmul does not; no collective kernel gives ``pairs == 0``),
    with the matmul kernels found through their correlation id and the CPU
    op that launched them, not by name; a collective issued after its
    backward pass (``train.backward`` ranges) does not count the next
    step's matmuls;
  * ``train.step.flat_grad_parts`` bitwise the reference's on the same
    numpy gradients and Bucketer sizes, and ``flat_grads`` (the front half
    of ``train_step``) as its whole vector and as bucket parts;
  * the micro's chain gradient, through its hooks and the exchange on one
    rank with the identity compressor (the exchange then returns its
    input), within f32 tolerance (rtol 1e-5, atol 1e-7) of ``jax.grad``
    of the reference's loss on the reference's weights;
  * the micro's exchange over 2 gloo ranks, fed the reference's
    gradients: the wire's sign bits bitwise ``repro.testutils.reference``'s
    compressed allreduce, its scales, output and EF slots at
    ``tests/test_torch_exchange.py``'s tolerances, and the EF identity
    ``decompress(payload) + new_err == x + err`` for the worker payloads;
  * ``--bwd --device cpu`` on one rank prints SKIP and exits 0.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import _torch_overlap_bwd_worker as worker  # noqa: E402
from repro.core.compression import (CompressionConfig, ef_compress,  # noqa
                                    pack_signs)
from repro.pipeline import Bucketer as JBucketer  # noqa: E402
from repro.testutils.reference import \
    compressed_allreduce_reference  # noqa: E402
from repro.train.step import flat_grad_parts as jflat_grad_parts  # noqa
from repro_torch.benchmarks.overlap_check import (  # noqa: E402
    build_bwd_exchange, check_bwd_trace)
from repro_torch.core.compression import padded_length  # noqa: E402
from repro_torch.kernels.onebit import ref as onebit_ref  # noqa: E402
from repro_torch.obs.trace import BACKWARD_SPAN  # noqa: E402
from repro_torch.optim.compressors import IdentityCompressor  # noqa: E402
from repro_torch.train.step import flat_grad_parts  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BLOCK = 512
N_LAYERS, WIDTH = 4, 64


# --------------------------------------------------------------------------
# check_bwd_trace on made-up traces
# --------------------------------------------------------------------------

class _Trace:
    """A Kineto-shaped event list: CPU ops on the main thread (tid 1) and
    the autograd thread (tid 2), each kernel launched by a
    ``cudaLaunchKernel`` that its ``correlation`` joins it to."""

    def __init__(self):
        self.events, self._corr = [], 0

    def op(self, name, ts, dur, tid=2, cat="cpu_op"):
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 1,
                            "tid": tid, "ts": ts, "dur": dur, "args": {}})

    def kernel(self, name, launch_ts, ts, dur, stream=7, tid=2):
        self._corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "pid": 1,
                            "tid": tid, "ts": launch_ts, "dur": 2,
                            "args": {"correlation": self._corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": name,
                            "pid": 0, "tid": stream, "ts": ts, "dur": dur,
                            "args": {"correlation": self._corr,
                                     "stream": stream}})


def _dot(t, name, launch_ts, ts, dur=20):
    """A matmul: a kernel launched inside an ``aten::mm`` (its name is
    deliberately not a GEMM's)."""
    t.op("aten::mm", launch_ts - 1, 5)
    t.kernel(name, launch_ts, ts, dur)


def test_collective_between_dots_counts():
    t = _Trace()
    _dot(t, "void at::native::vectorized_elementwise_kernel", 10, 100)
    # a kernel named like a GEMM, launched by an add: not a dot
    t.op("aten::add_", 19, 4)
    t.kernel("sm90_xmma_gemm_bf16bf16_bf16f32", 20, 125, 5)
    t.op("record_param_comms", 29, 4)
    t.kernel("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             30, 130, 50, stream=20)
    _dot(t, "nvjet_tst_128x256_64x4", 40, 140)
    out = check_bwd_trace(t.events)
    assert out["pairs"] == 1
    assert out["n_dots"] == 2
    assert out["overlapped_bwd"] == 1
    (det,) = out["details"]
    assert det["overlapped_bwd"] is True
    assert det["dots_after"] == 1 and det["dots_before"] == 1
    assert det["kind"] == "all-to-all" and det["stream"] == 20
    assert det["index"] == 2          # the third kernel on the device
    # the NCCL kernel runs 130-180 us; the second dot covers 140-160
    assert det["us"] == 50 and det["under_dots_us"] == 20
    assert det["device_dots_after"] == 1
    assert out["streams"] == {"20": 1}


def test_collective_after_all_dots_does_not_count():
    t = _Trace()
    _dot(t, "k0", 10, 100)
    _dot(t, "k1", 20, 130)
    t.kernel("ncclDevKernel_AllGather_RING_LL", 30, 160, 20, stream=20)
    out = check_bwd_trace(t.events)
    assert out["pairs"] == 1 and out["n_dots"] == 2
    assert out["overlapped_bwd"] == 0
    assert out["details"][0]["dots_after"] == 0
    assert out["details"][0]["kind"] == "all-gather"


def test_no_collective_kernel_means_nothing_to_check():
    t = _Trace()
    _dot(t, "k0", 10, 100)
    out = check_bwd_trace(t.events)
    assert out["pairs"] == 0 and out["n_dots"] == 1
    assert out["overlapped_bwd"] == 0


def test_collective_after_its_backward_does_not_count_next_step():
    """Two steps: step 0's backward (a ``train.backward`` range) issues
    one collective inside and one after it; step 1's matmuls come after
    both and are not the late one's."""
    t = _Trace()
    t.op(BACKWARD_SPAN, 0, 100, tid=1, cat="user_annotation")
    _dot(t, "k0", 10, 1000)
    t.kernel("ncclDevKernel_SendRecv", 30, 1030, 10, stream=20)
    _dot(t, "k1", 40, 1040)
    t.kernel("ncclDevKernel_AllGather", 150, 1100, 10, stream=20)
    t.op(BACKWARD_SPAN, 300, 100, tid=1, cat="user_annotation")
    _dot(t, "k2", 310, 1300)
    _dot(t, "k3", 320, 1330)
    out = check_bwd_trace(t.events)
    assert out["backward_passes"] == 2 and out["n_dots"] == 4
    inside, late = out["details"]
    assert inside["overlapped_bwd"] and inside["in_backward"]
    assert inside["dots_before"] == 1 and inside["dots_after"] == 1
    assert not late["in_backward"] and not late["overlapped_bwd"]
    assert late["dots_after"] == 0
    assert out["overlapped_bwd"] == 1


# --------------------------------------------------------------------------
# the gradient parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,pad", [(1, 2, 0), (2, 3, 700), (4, 4, 3000)])
def test_flat_grad_parts_bitwise_reference(n, nb, pad):
    rng = np.random.default_rng(nb)
    shapes = [(64, 48), (17,), (3, 5, 7), (1024,)]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    d = sum(int(np.prod(s)) for s in shapes)
    d_pad = padded_length(d + pad, n, 256)
    sizes = JBucketer.for_exchange(d_pad, n, 256, nb).sizes
    want = jflat_grad_parts([jnp.asarray(g) for g in grads], sizes, d_pad)
    got = flat_grad_parts([torch.from_numpy(g) for g in grads], sizes,
                          d_pad)
    assert len(got) == len(want) == len(sizes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = np.concatenate([g.ravel() for g in grads])
    np.testing.assert_array_equal(
        torch.cat(got).numpy(), np.pad(flat, (0, d_pad - d)))
    # a {path: tensor} dict is taken in ravel (sorted path) order
    named = {f"b.{i}": torch.from_numpy(g) for i, g in enumerate(grads)}
    for a, b in zip(flat_grad_parts(named, sizes, d_pad), got):
        assert torch.equal(a, b)


def test_flat_grads_matches_reference():
    """``flat_grads`` (two microbatches) against the reference's on the
    same parameters and batch, as a whole vector and as bucket parts, at
    ``tests/test_torch_model.py``'s gradient tolerance; the parts are
    bitwise the whole vector's slices."""
    from repro.configs import get_config as jget_config
    from repro.configs.base import InputShape
    from repro.data import make_batch
    from repro.models import transformer as JT
    from repro.models.common import ParallelCtx
    from repro.train.step import flat_grads as jflat_grads
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import flat_grads, init_train_state
    arch = "bert-base-smoke"
    jcfg = jget_config(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    batch = make_batch(jcfg, InputShape("t", 32, 4, "train"),
                       jax.random.PRNGKey(100))
    ts = init_train_state(get_config(arch),
                          params_from_jax(jax.tree.map(np.asarray, jparams)),
                          get_optimizer("onebit_adam"), BLOCK)
    d_pad = ts.x.shape[0]
    sizes = JBucketer.for_exchange(d_pad, 1, BLOCK, 3).sizes
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    g, segs, total, _ = flat_grads(ts, tbatch, accum_steps=2)
    assert g is ts.g and segs is ts.segs
    whole = g.clone()
    parts, *_ = flat_grads(ts, tbatch, accum_steps=2, bucket_sizes=sizes)
    assert torch.equal(torch.cat(parts), whole)
    # the reference's parts concatenate to its whole vector, bitwise
    jparts, jsegs, jtotal, _ = jflat_grads(jparams, batch, jcfg,
                                           ParallelCtx(), 0.01, 2, d_pad,
                                           bucket_sizes=sizes)
    assert segs.n == jsegs.n
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    want = np.concatenate([np.asarray(p) for p in jparts])
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-4, atol=atol)
    for a, b in zip(parts, jparts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=atol)


# --------------------------------------------------------------------------
# the micro
# --------------------------------------------------------------------------

def _reference_micro(n):
    """The reference's weights and inputs (``build_bwd_exchange``'s
    draws) and ``jax.grad`` of its loss on each rank's x."""
    ws = [np.asarray(jax.random.normal(jax.random.PRNGKey(i),
                                       (WIDTH, WIDTH), jnp.float32) / WIDTH)
          for i in range(N_LAYERS)]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(99), (n, 8, WIDTH),
                                     jnp.float32))

    def loss(ws, x):
        h = x
        for w in ws:
            h = jnp.tanh(h @ w)
        return jnp.sum(h * h)

    grads = [[np.asarray(g) for g in
              jax.grad(loss)([jnp.asarray(w) for w in ws], jnp.asarray(xr))]
             for xr in x]
    return ws, x, grads


def test_micro_chain_gradient_matches_jax_grad():
    ws, x, grads = _reference_micro(1)
    d = N_LAYERS * WIDTH * WIDTH
    out, werr, serr = build_bwd_exchange(
        (1,), BLOCK, 2, N_LAYERS, WIDTH, ws=ws, x=x,
        comp=IdentityCompressor(block_size=BLOCK), device="cpu")
    want = np.concatenate([g.ravel() for g in grads[0]])
    assert out.shape == (padded_length(d, 1, BLOCK),)
    np.testing.assert_allclose(out[:d].numpy(), want, rtol=1e-5, atol=1e-7)
    assert not werr.any() and not serr.any()
    # the same gradients landed through the hooks' code: the same output
    out2, _, _ = build_bwd_exchange(
        (1,), BLOCK, 2, N_LAYERS, WIDTH, ws=ws, x=x, grads=grads[0],
        comp=IdentityCompressor(block_size=BLOCK), device="cpu")
    np.testing.assert_array_equal(out2[:d].numpy(), want)


def test_micro_exchange_over_gloo_matches_reference_oracle(tmp_path):
    n, nb = 2, 2
    ws, x, grads = _reference_micro(n)
    np.savez(tmp_path / "inputs.npz", n_layers=N_LAYERS, x=x,
             **{f"w{i}": w for i, w in enumerate(ws)},
             **{f"g{r}_{i}": g for r in range(n)
                for i, g in enumerate(grads[r])})
    mp.start_processes(worker.micro_main, args=(n, str(tmp_path), BLOCK,
                                                nb),
                       nprocs=n, start_method="spawn")
    d = N_LAYERS * WIDTH * WIDTH
    d_pad = padded_length(d, n, BLOCK)
    flats = [np.pad(np.concatenate([g.ravel() for g in grads[r]]),
                    (0, d_pad - d)) for r in range(n)]
    cfg = CompressionConfig(block_size=BLOCK)
    zeros = jnp.zeros(d_pad, jnp.float32)
    jout, jwerrs, jserr = compressed_allreduce_reference(
        [jnp.asarray(f) for f in flats], [zeros] * n, zeros, cfg)
    jout, jserr = np.asarray(jout), np.asarray(jserr)
    sizes = JBucketer.for_exchange(d_pad, n, BLOCK, nb).sizes
    offs = np.cumsum((0,) + sizes)
    for r in range(n):
        res = np.load(tmp_path / f"micro{r}.npz")
        np.testing.assert_allclose(res["out"], jout, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["werr"], np.asarray(jwerrs[r]),
                                   rtol=1e-5, atol=1e-6)
        # this rank serves the r-th chunk of every bucket, in bucket order
        served = np.concatenate([np.arange(offs[b] + r * sizes[b] // n,
                                           offs[b] + (r + 1) * sizes[b] // n)
                                 for b in range(nb)])
        np.testing.assert_allclose(res["serr"], jserr[served], rtol=1e-5,
                                   atol=1e-6)
        # the payloads: the worker's one a bucket, then the server's, each
        # issued last bucket first
        assert int(res["n_payloads"]) == 2 * nb
        for i, b in enumerate(reversed(range(nb))):
            lo, hi = offs[b], offs[b + 1]
            (jpk, jsc), _ = ef_compress(jnp.asarray(flats[r][lo:hi]),
                                        jnp.zeros(hi - lo), cfg)
            np.testing.assert_array_equal(res[f"p{i}_0"], np.asarray(jpk))
            np.testing.assert_allclose(res[f"p{i}_1"], np.asarray(jsc),
                                       rtol=1e-6, atol=0.0)
            recon = onebit_ref.decompress(
                torch.from_numpy(res[f"p{i}_0"]),
                torch.from_numpy(res[f"p{i}_1"]), BLOCK).numpy()
            np.testing.assert_allclose(recon + res["werr"][lo:hi],
                                       flats[r][lo:hi], rtol=1e-5,
                                       atol=1e-6)
            # the server payload of the bucket: the signs of the output
            # elements this rank serves in it
            c = sizes[b] // n
            mine = jout[lo + r * c:lo + (r + 1) * c]
            np.testing.assert_array_equal(res[f"p{nb + i}_0"],
                                          np.asarray(pack_signs(mine)))


def test_bwd_one_rank_skips():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.overlap_check",
         "--bwd", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=os.path.abspath(SRC)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[SKIP] one rank: no collective" in proc.stdout
    assert "overlap_check --bwd" in proc.stdout
