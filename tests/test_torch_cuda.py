"""The port's Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without a card.  The file imports torch and
the port only, so it runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: packed sign bits and decompress bitwise; scales rtol 1e-6 and
new_err rtol 1e-5 / atol 1e-6 (the block sum runs in another order than
torch's mean); Adam rtol 1e-5 / atol 5e-7 (tests/test_kernels.py's);
flash attention f32 rtol 1e-5 / atol 2e-6 (tests/test_kernels.py's; the
online softmax sums in another order), bf16 and fp16 rtol 2e-2 (that
file's bf16 rtol) / atol 5e-3 (the tensor-core kernel rounds p to the
input dtype before p v; chip_smoke.py reads the least atol that passes,
at most 2.9e-3); head dims above 256 (the wide SIMT instance) f32 rtol
1e-5 / atol 1e-5 (the scores sum up to 1024 products), 16-bit as above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_adam import kernel as adam_kernel  # noqa: E402
from repro_torch.kernels.fused_adam import ref as adam_ref  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fa_ref  # noqa: E402
from repro_torch.kernels.onebit import kernel as onebit_kernel  # noqa: E402
from repro_torch.kernels.onebit import ref as onebit_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(card, seed, n, scale=1.0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(n, generator=gen, device=card) * scale


@pytest.mark.parametrize("block", [8, 24, 40, 256, 512, 520, 4096])
def test_onebit_kernels_match_plain(card, block):
    x, err = _randn(card, 0, 64 * block), _randn(card, 1, 64 * block, 0.1)
    # +0.0 and -0.0 (buf = -0.0 + -0.0) both pack as 1
    x[:2] = err[:2] = torch.tensor([0.0, -0.0], device=card)
    before = build.launch_counts()
    pk, sc, ne = onebit_kernel.ef_compress_fused(x, err, block)
    rpk, rsc, rne = onebit_ref.ef_compress_fused(x, err, block)
    assert torch.equal(pk, rpk)
    torch.testing.assert_close(sc, rsc, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ne, rne, rtol=1e-5, atol=1e-6)
    assert torch.equal(onebit_kernel.decompress(rpk, rsc, block),
                       onebit_ref.decompress(rpk, rsc, block))
    after = build.launch_counts()
    assert after["ef_compress"] == before["ef_compress"] + 1
    assert after["decompress"] == before["decompress"] + 1


@pytest.mark.parametrize("block,n_blocks,offset", [
    (8, 129, 0), (8, 129, 1), (24, 43, 0), (40, 25, 3), (520, 3, 0),
    (4096, 3, 1)])
def test_decompress_bitwise_at_ragged_lengths(card, block, n_blocks, offset):
    """d = block * n_blocks is not a multiple of one warp's 1024-element
    chunk (except at 4096); a payload at a byte offset takes the unaligned
    loads."""
    d = block * n_blocks
    x, err = _randn(card, 5, d), _randn(card, 6, d, 0.1)
    pk, sc, _ = onebit_ref.ef_compress_fused(x, err, block)
    buf = torch.zeros(pk.numel() + offset, dtype=torch.uint8, device=card)
    buf[offset:] = pk
    before = build.launch_counts()["decompress"]
    got = onebit_kernel.decompress(buf[offset:], sc, block)
    assert build.launch_counts()["decompress"] == before + 1
    assert torch.equal(got, onebit_ref.decompress(pk, sc, block))


def test_onebit_kernel_packs_nan_as_zero(card):
    """buf >= 0 is false for NaN: its sign bit packs 0, as in the plain
    version and the reference."""
    x = _randn(card, 4, 512)
    x[5] = float("nan")
    err = torch.zeros_like(x)
    pk, _, _ = onebit_kernel.ef_compress_fused(x, err, 512)
    rpk, _, _ = onebit_ref.ef_compress_fused(x, err, 512)
    assert torch.equal(pk, rpk)
    assert int(pk[0]) >> 5 & 1 == 0


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_kernel_matches_plain(card, wd):
    x, m, g = (_randn(card, s, 8192 * 4, sc)
               for s, sc in ((0, 1.0), (1, 0.01), (2, 0.01)))
    v = _randn(card, 3, 8192 * 4, 1e-4).abs()
    got = adam_kernel.adam_step(x, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
    want = adam_ref.adam_step(x, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-7)


def test_small_run_on_card_matches_cpu(card):
    """The port's run on the card and on the CPU from one seed (same CPU
    generator init, same numpy batches) agree to rtol 1e-3 (cuBLAS and the
    CPU BLAS sum in other orders; compressed steps can flip single sign
    bits near zero)."""
    from repro_torch.launch.train import run
    kw = dict(arch="bert-large-smoke", steps=4, warmup_steps=2, batch=2,
              seq=32, block_size=512, lr=2e-3, lr_warmup=2, verbose=False)
    on_card = run(device="cuda", **kw)
    assert on_card["launches"] == {"adam_step": 2, "ef_compress": 4,
                                   "decompress": 4, "flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "flash_attention_wide": 0}
    cpu = run(device="cpu", **kw)
    np.testing.assert_allclose([h["loss"] for h in on_card["history"]],
                               [h["loss"] for h in cpu["history"]],
                               rtol=1e-3)


def _flash_case(card, shape, dtype, causal, window, fn=None, tol=None):
    """The kernel's output, the plain version's, and which counter moved."""
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for _ in range(3))
    before = build.launch_counts()
    got = (fn or fa_kernel.flash_attention)(q, k, v, causal=causal,
                                            window=window)
    want = fa_ref.sdpa(q, k, v, causal=causal, window=window)
    after = build.launch_counts()
    moved = {n for n in after if after[n] != before[n]}
    assert all(after[n] == before[n] + 1 for n in moved)
    assert got.dtype == dtype and got.shape == q.shape
    tol = tol or (dict(rtol=1e-5, atol=2e-6) if dtype == torch.float32
                  else dict(rtol=2e-2, atol=5e-3))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    return moved


@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((1, 2, 256, 64), torch.float32, True, None),
    ((1, 2, 192, 128), torch.float32, False, None),
    ((1, 2, 256, 32), torch.float32, True, 64),
    ((2, 3, 320, 128), torch.bfloat16, True, None),
])
def test_flash_kernel_matches_plain(card, shape, dtype, causal, window):
    """Each dtype takes its route: f32 the SIMT kernel, bf16 the
    tensor-core kernel."""
    moved = _flash_case(card, shape, dtype, causal, window)
    assert moved == ({"flash_attention"} if dtype == torch.float32
                     else {"flash_attention_wgmma"})


@pytest.mark.parametrize("s", [320, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (True, 128)])
def test_wgmma_flash_matches_plain(card, s, d, dtype, causal, window):
    """The tensor-core kernel at ragged S (not a multiple of its 128-row
    tiles), causal and not, sliding windows."""
    moved = _flash_case(card, (2, 3, s, d), dtype, causal, window)
    assert moved == {"flash_attention_wgmma"}


@pytest.mark.parametrize("d", [1, 48, 80, 96, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_head_dims(card, d, dtype):
    """Every D from 1 to 256 is taken (zero-padded to an instance of the
    dtype's kernel); D = 300 takes the wide SIMT instance (padded to 320)
    in every dtype."""
    moved = _flash_case(card, (1, 2, 200, d), dtype, True, None)
    assert moved == ({"flash_attention"} if dtype == torch.float32
                     else {"flash_attention_wgmma"})
    moved = _flash_case(card, (1, 1, 64, 300), dtype, True, None,
                        tol=WIDE_TOL[dtype])
    assert moved == {"flash_attention_wide"}


# f32 above D = 256: the scores sum up to 1024 products, so their rounding
# grows with D (an H100 read a max abs err of 4.9e-6 at D = 1000).  16-bit:
# the wide instance keeps p and the accumulator in f32, as the plain version
# does, and rounds only the output, so the two differ by at most an output
# ulp: ulp/|o| is at most 2^-7 (bf16) or 2^-10 (fp16), hence rtol 8e-3 and
# 1e-3; atol 1e-5 covers outputs near zero (fp16 subnormals below 6.1e-5)
WIDE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=8e-3, atol=1e-5),
            torch.float16: dict(rtol=1e-3, atol=1e-5)}


@pytest.mark.parametrize("d", [320, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
def test_wide_flash_matches_plain(card, d, dtype, causal, window):
    """Head dims above 256 in every dtype take the wide SIMT instance
    (D streamed in 64-column slices, the accumulator in f32 scratch)."""
    moved = _flash_case(card, (1, 2, 200, d), dtype, causal, window,
                        tol=WIDE_TOL[dtype])
    assert moved == {"flash_attention_wide"}


def test_segment_norms_are_deterministic(card):
    """1-bit LAMB's segment norms on the card: one reduction per range, so
    two calls on the same input are bitwise equal (a resume needs it)."""
    from repro_torch.optim.base import SegmentInfo, segment_l1, segment_norms
    n = 1 << 24
    x = _randn(card, 5, n)
    segs = SegmentInfo((n // 2 + 4096, n // 4, n // 4 - 4096 - 8, 8))
    for fn in (segment_norms, segment_l1):
        a, b = fn(x, segs), fn(x, segs)
        assert torch.equal(a, b)
        want = torch.stack([fn(x[lo:hi].cpu(), SegmentInfo((hi - lo,)))[0]
                            for lo, hi in segs.ranges()])
        torch.testing.assert_close(a.cpu(), want, rtol=1e-5, atol=0.0)


def test_simt_flash_kernel_takes_bf16(card):
    """The SIMT kernel on bf16 (timed beside the tensor-core kernel) is
    counted as its own route."""
    moved = _flash_case(card, (1, 2, 320, 128), torch.bfloat16, True, None,
                        fa_kernel.flash_attention_simt)
    assert moved == {"flash_attention"}


def test_nccl_exchange_carries_both_payloads(card, tmp_path):
    """The compressed exchange over NCCL on every card present (2 to 4;
    skipped with one): the top-k payload (f32 values, uint16 indices as
    their bytes) and the 1-bit one cross the wire, and each rank's result
    is the same exchange's over gloo on the CPU: top-k bitwise (copies, and
    the chunk mean sums in rank order on both), 1-bit to the scales'
    rtol 1e-6 and the residuals' rtol 1e-5 / atol 1e-6 (the kernel's block
    means sum in another order than torch's)."""
    import torch.multiprocessing as mp
    import _torch_exchange_worker as worker
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs 2 or more cards for NCCL collectives")
    block = 4096
    rng = np.random.default_rng(3)
    d = n * 8 * block
    np.savez(tmp_path / "inputs.npz",
             xs=rng.standard_normal((n, d)).astype(np.float32),
             werrs=(rng.standard_normal((n, d)) * 0.1).astype(np.float32),
             serrs=(rng.standard_normal((n, d // n)) * 0.1)
             .astype(np.float32))
    for backend in ("nccl", "gloo"):
        mp.start_processes(worker.payloads_main,
                           args=(n, str(tmp_path), block, backend),
                           nprocs=n, start_method="spawn")
    for r in range(n):
        got = np.load(tmp_path / f"nccl{r}.npz")
        want = np.load(tmp_path / f"gloo{r}.npz")
        for k in ("topk_out", "topk_werr", "topk_serr"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["onebit_out"], want["onebit_out"],
                                   rtol=1e-6)
        for k in ("onebit_werr", "onebit_serr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
