"""The port's Hopper kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without a card.  The file imports torch and
the port only, so it runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py

The NCCL tests need 2 (the payload exchange) or 4 cards (the
hierarchical exchange and training on a 2 x 2 pod x data mesh) and skip
with fewer; their ranks are spawned processes (``_torch_exchange_worker``,
``_torch_hier_worker``), one card each, compared with the same runs over
gloo on the CPU or with each other.

Tolerances: packed sign bits and decompress bitwise; scales rtol 1e-6 and
new_err rtol 1e-5 / atol 1e-6 (the block sum runs in another order than
torch's mean); Adam rtol 1e-5 / atol 5e-7 (tests/test_kernels.py's);
flash attention f32 rtol 1e-5 / atol 2e-6 (tests/test_kernels.py's; the
online softmax sums in another order; the f32 route's three-term bf16
split keeps f32 accuracy), bf16 and fp16 rtol 2e-2 (that file's bf16
rtol) / atol 5e-3 (the wgmma kernel rounds p to the input dtype before
p v; chip_smoke.py reads the least atol that passes, at most 2.9e-3);
head dims above 256 (the split kernel's wide route) f32 rtol 1e-5 / atol
1e-5 (the scores sum up to 1024 products), 16-bit at one output ulp
(``WIDE_TOL``).  The model families: a run's losses on the card and on
the CPU rtol 1e-3 (``test_small_run_on_card_matches_cpu``'s); a bf16
MoE layer's two dispatches at one bf16 ulp; the f32 layer against the
CPU rtol 1e-5 (gradients 1e-4), atol 1e-5 of the largest entry.
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


@pytest.mark.parametrize("block", [8, 512, 4096])
def test_onebit_kernels_write_into_slices(card, block):
    """``out=`` a slice of a larger tensor at a block offset (as the
    pipelined executor hands them a bucket's slice): bitwise the calls
    that allocate, each one launch; an ``out`` off the 16-byte alignment
    of decompress's float4 stores, or of the wrong length, is refused."""
    d = 8 * block
    x, err = _randn(card, 7, d), _randn(card, 8, d, 0.1)
    pk, sc, ne = onebit_kernel.ef_compress_fused(x, err, block)
    big = torch.full((3 * d,), 7.0, device=card)
    dst = big[block:block + d]
    before = build.launch_counts()
    pk2, sc2, ne2 = onebit_kernel.ef_compress_fused(x, err, block, out=dst)
    dec = onebit_kernel.decompress(pk, sc, block, out=big[2 * d:])
    after = build.launch_counts()
    assert ne2.data_ptr() == dst.data_ptr() and torch.equal(ne2, ne)
    assert torch.equal(pk2, pk) and torch.equal(sc2, sc)
    assert dec.data_ptr() == big[2 * d:].data_ptr()
    assert torch.equal(dec, onebit_kernel.decompress(pk, sc, block))
    assert torch.equal(big[:block], torch.full((block,), 7.0, device=card))
    assert after["ef_compress"] == before["ef_compress"] + 1
    assert after["decompress"] == before["decompress"] + 1
    with pytest.raises(ValueError):
        onebit_kernel.decompress(pk, sc, block, out=big[1:1 + d])
    with pytest.raises(ValueError):
        onebit_kernel.ef_compress_fused(x, err, block, out=big[:d - 8])


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
                                   "flash_attention_wide": 0,
                                   "lm_head_xent_fwd": 4,
                                   "lm_head_xent_bwd": 4,
                                   "moe_permute": 0, "moe_combine": 0}
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
    """Each dtype takes its route: f32 the split kernel, bf16 the wgmma
    kernel."""
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
    dtype's kernel); D = 300 takes the wide route (the split kernel, padded
    to 320) in every dtype."""
    moved = _flash_case(card, (1, 2, 200, d), dtype, True, None)
    assert moved == ({"flash_attention"} if dtype == torch.float32
                     else {"flash_attention_wgmma"})
    moved = _flash_case(card, (1, 1, 64, 300), dtype, True, None,
                        tol=WIDE_TOL[dtype])
    assert moved == {"flash_attention_wide"}


# f32 above D = 256: the scores sum up to 1024 products, so their rounding
# grows with D (an H100 read a max abs err of 4.9e-6 at D = 1000).  16-bit:
# the wide route keeps p to 16 bits or more (two terms of the input dtype)
# and the accumulator in f32, as the plain version keeps p and o in f32, and
# rounds only the output, so the two differ by at most about an output ulp:
# ulp/|o| is at most 2^-7 (bf16) or 2^-10 (fp16), hence rtol 8e-3 and 1e-3;
# atol 1e-5 covers outputs near zero (fp16 subnormals below 6.1e-5)
WIDE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=8e-3, atol=1e-5),
            torch.float16: dict(rtol=1e-3, atol=1e-5)}


@pytest.mark.parametrize("d", [320, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
def test_wide_flash_matches_plain(card, d, dtype, causal, window):
    """Head dims above 256 in every dtype take the wide route (the split
    kernel: one CTA per 256 (16-bit) or 128 (f32) output columns, q and k
    streamed through the score in 64-column chunks above 512 / 128)."""
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


@pytest.mark.parametrize("causal,window", [(True, None), (False, 256)])
def test_f32_route_long_sequence(card, causal, window):
    """The f32 route over many kv tiles (S = 1536, 48 of its 32-key tiles)
    keeps the f32 tolerance: each tile's p v is summed into o in f32."""
    moved = _flash_case(card, (1, 4, 1536, 128), torch.float32, causal,
                        window)
    assert moved == {"flash_attention"}


@pytest.mark.parametrize("arch", ["mixtral-8x22b-smoke",
                                  "falcon-mamba-7b-smoke",
                                  "jamba-1.5-large-398b-smoke",
                                  "musicgen-large-smoke",
                                  "internvl2-2b-smoke"])
def test_family_run_on_card_matches_cpu(card, arch):
    """One arch of each family beyond the dense ones (MoE, SSM, hybrid,
    audio and VLM stubs) through ``run`` on the card and on the CPU from
    one seed: 2 warmup steps and the first compressed step's loss (taken
    before any compressed update, so the routing of a MoE layer cannot
    yet differ) agree to rtol 1e-3, the launches are the optimizer
    path's and one LM-head launch each way a step, aux is positive
    exactly with experts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    seq = 48 if arch.startswith("internvl2") else 32
    kw = dict(arch=arch, steps=3, warmup_steps=2, batch=2, seq=seq,
              block_size=512, lr=2e-3, lr_warmup=2, verbose=False)
    on_card = run(device="cuda", **kw)
    assert on_card["launches"] == {"adam_step": 2, "ef_compress": 2,
                                   "decompress": 2, "flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "flash_attention_wide": 0,
                                   "lm_head_xent_fwd": 3,
                                   "lm_head_xent_bwd": 3,
                                   "moe_permute": 0, "moe_combine": 0}
    cpu = run(device="cpu", **kw)
    np.testing.assert_allclose([h["loss"] for h in on_card["history"]],
                               [h["loss"] for h in cpu["history"]],
                               rtol=1e-3)
    aux = [h["aux"] for h in on_card["history"]]
    assert (min(aux) > 0) if get_config(arch).n_experts else not any(aux)


def _moe_case(card, dtype, dispatch, device, d=768, ff=1024, e=8):
    """A MoE layer (top-2 of ``e`` experts, t = 512) forward + backward:
    (y, aux, x.grad, the router's grad) on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.mlp import moe_forward
    cfg = dataclasses.replace(
        get_config("mixtral-8x22b"), d_model=d, d_ff=ff, n_experts=e,
        moe_dispatch=dispatch, compute_dtype=str(dtype).split(".")[-1])
    gen = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(d, e, generator=gen) * 0.02,
         "wg": torch.randn(e, d, ff, generator=gen) * d ** -0.5,
         "wu": torch.randn(e, d, ff, generator=gen) * d ** -0.5,
         "wd": torch.randn(e, ff, d, generator=gen) * ff ** -0.5}
    x = torch.randn(2, 256, d, generator=gen)
    cot = torch.randn(2, 256, d, generator=gen)
    p = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
    x = x.to(device=device, dtype=dtype).requires_grad_(True)
    y, aux = moe_forward(p, x, cfg)
    ((y.float() * cot.to(device)).sum() + aux).backward()
    return [t.detach().float().cpu() for t in
            (y, aux, x.grad, p["router"].grad)]


def test_moe_dispatches_agree_on_card(card):
    """The einsum and the gather dispatch of a bf16 MoE layer on the card
    (a reduced size of chip_smoke.py's phase 15c): one-hot dispatch moves
    each token exactly and both sum the experts in expert order, so the
    bf16 output and input gradient agree to one bf16 ulp."""
    ye, ae, ge, _ = _moe_case(card, torch.bfloat16, "einsum", card)
    yg, ag, gg, _ = _moe_case(card, torch.bfloat16, "gather", card)
    torch.testing.assert_close(yg, ye, rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(gg, ge, rtol=2 ** -7, atol=1e-6)
    assert float(ae) == float(ag)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_layer_on_card_matches_cpu(card, dispatch):
    """The f32 MoE layer on the card (TF32 off) against the CPU: the
    output rtol 1e-5 and the gradients rtol 1e-4, each with an atol of
    1e-5 of its largest entry (cuBLAS and the CPU BLAS sum the d and d_ff
    products in other orders; near-zero outputs keep only the absolute
    error, which an H100 read at 1.5e-6)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _moe_case(card, torch.float32, dispatch, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = _moe_case(card, torch.float32, dispatch, "cpu")
    torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                               atol=1e-5 * float(want[0].abs().max()))
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


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


def _four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: the 2 x 2 (pod x data) mesh is one rank "
                    "a card")


def test_nccl_hier_exchange_matches_gloo(card, tmp_path):
    """The hierarchical exchange over NCCL on a 2 x 2 (pod x data) mesh of
    four cards: three chained exchanges per compressor (``onebit`` with
    EF-free cross-pod legs, ``topk`` with the ``outer`` / ``outer_ag``
    slots, ``identity`` with a cross-pod all-reduce), serial and over 3
    buckets.  Every rank's output and EF slots equal the same run over
    gloo on the CPU: top-k and identity bitwise (copies, sums of two);
    1-bit outputs (+-scale) at the scales' rtol 1e-6, its residuals at
    rtol 1e-5 / atol 1e-6 (the kernel's block means sum in another order
    than torch's)."""
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    _four_cards()
    block = 4096
    d = 7 * 4 * block
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "inputs.npz",
             xs=rng.standard_normal((hw.EXCHANGE_STEPS, 4, d))
             .astype(np.float32))
    for backend in ("nccl", "gloo"):
        mp.start_processes(hw.exchange_main,
                           args=(4, str(tmp_path), block, backend),
                           nprocs=4, start_method="spawn")
    for r in range(4):
        got = np.load(tmp_path / f"nccl{r}.npz")
        want = np.load(tmp_path / f"gloo{r}.npz")
        assert bool(got["topk_no_outer_raised"])
        for k in want.files:
            if k.startswith("onebit") and k.endswith("_out"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=k)
            elif k.startswith("onebit"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# full-width BERT-Large on four cards (one rank a card, 16 x 128 a rank)
FOUR_CARD = dict(arch="bert-large", block=4096, seq=128, batch=64, steps=6,
                 warmup=3, mesh="2x2x1", digest=True)
FOUR_CARD_NB = 2


def test_nccl_hier_training_pipelined_bitwise_serial(card, tmp_path):
    """1-bit Adam 3 + 3 steps of full-width BERT-Large on four NCCL ranks as
    2 pods x 2, ``topology="hier"``: with 2 buckets and backward overlap
    the run is bitwise the serial one on every rank (losses, parameters,
    ``m``, ``worker_err``: SHA-256 of each), the parameters are bitwise
    equal across ranks, and each rank launches ``ef_compress`` and
    ``decompress`` 4 x NB times a compressed step (worker EF, the two
    cross-pod legs' compress, server EF; four decompresses) and
    ``adam_step`` once a warmup step; every stage 0 but the embedding's
    bucket's issues before the last gradient lands.  Prints each run's
    step walls, and those of the flat exchange on the same cards: one
    machine's NVLink carries both tiers, so the hierarchical schedule's
    saving of cross-pod bytes has no slow link to show on."""
    import json
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    _four_cards()
    runs = {"hier_serial": dict(FOUR_CARD, topology="hier", n_buckets=1,
                                overlap=False),
            "hier_pipe": dict(FOUR_CARD, topology="hier",
                              n_buckets=FOUR_CARD_NB, overlap=True),
            "flat_serial": dict(FOUR_CARD, topology="flat", n_buckets=1,
                                overlap=False)}
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(runs, f)
    mp.start_processes(hw.steps_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [np.load(tmp_path / f"steps{r}.npz") for r in range(4)]
    w = FOUR_CARD["warmup"]
    for r, got in enumerate(ranks):
        for k in ("loss", "x", "opt_m", "opt_worker_err", "opt_v"):
            assert got[f"hier_pipe__{k}"].tolist() == \
                got[f"hier_serial__{k}"].tolist(), (r, k)
        assert got["hier_pipe__x"].tolist() == ranks[0]["hier_pipe__x"]\
            .tolist()
        assert np.isfinite(got["hier_serial__loss"]).all()
        # the bucket holding the embedding, whose gradient lands last,
        # issues last: every other stage 0 issues inside backward
        assert got["hier_pipe__stage0_in_bwd"].tolist() == [0] * w + [
            FOUR_CARD_NB - 1] * (FOUR_CARD["steps"] - w), r
        for name, nb in (("hier_serial", 1), ("hier_pipe", FOUR_CARD_NB)):
            launches = got[f"{name}__launches"].tolist()
            assert launches == [[1, 0, 0]] * w + [[0, 4 * nb, 4 * nb]] * (
                FOUR_CARD["steps"] - w), (r, name, launches)
        assert got["flat_serial__launches"].tolist()[w:] == [[0, 2, 2]] * (
            FOUR_CARD["steps"] - w)
    for name in runs:
        print(f"[nccl4] {name}: step ms by rank "
              + json.dumps([got[f"{name}__ms"].round(1).tolist()
                            for got in ranks])
              + f"; losses {ranks[0][name + '__loss'].tolist()}")


# 0/1 Adam's schedule of chip_smoke.py phase 6b: within 3 + 5 steps it
# synchronises at compressed steps 0, 1, 2 and 4 (step 3 is 0-bit) and
# refreshes v at counts 4, 6 and 8
ZERONE = dict(var_update_interval=2, sync_double_every=2,
              sync_max_interval=2)
ZERONE_SYNCS = [True] * 6 + [False, True]
LAYOUT_RUNS = {
    f"{name}_{comp}": dict(spec, compressor=comp)
    for comp in ("onebit", "topk", "identity")
    for name, spec in (
        ("zerone_local", dict(optimizer="zerone_adam", layout="local",
                              opt_kwargs=ZERONE, steps=8, warmup=3,
                              seed=1)),
        ("onebit_zero1", dict(optimizer="onebit_adam", zero1=True,
                              steps=6, warmup=3, seed=2)))}


def test_nccl_local_and_zero1_match_gloo(card, tmp_path):
    """The ``local`` layout (0/1 Adam, 3 + 5 steps with a 0-bit step and
    ``v`` refreshes) and zero1 compressed steps (1-bit Adam, 3 + 3 steps,
    ``seed_zero1`` at the switch) on a 2 x 2 mesh of four cards, each
    under the 1-bit, top-k and identity compressors: the optimizer's own
    updates (the calls ``train_step`` makes) over NCCL, and the same run
    over gloo with every rank's tensors on its card, so that the two
    differ only in the collectives.  Both are fed the same seeded
    gradients, whose dp sums are exact in f32, so the warmup all-reduce
    cannot differ with a backend's summation order.  Every rank's
    parameters and state after every step are bitwise the gloo run's,
    for every compressor (the card's kernels on the same inputs; the CPU
    cannot stand in: its ``torch.sqrt`` is not correctly rounded where
    the fused Adam kernel's is).  The parameters are bitwise equal across
    ranks, and each step launches 1 / 0 / 0 kernels in warmup
    (adam_step / ef_compress / decompress), 0 / 2 / 2 on a 1-bit sync
    step and none on a 0-bit step or under top-k or identity."""
    import json
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    _four_cards()
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(LAYOUT_RUNS, f)
    for backend in ("nccl", "gloo"):
        mp.start_processes(hw.layouts_main,
                           args=(4, str(tmp_path), backend, True), nprocs=4,
                           start_method="spawn")
    nccl = [np.load(tmp_path / f"layouts_nccl{r}.npz") for r in range(4)]
    gloo = [np.load(tmp_path / f"layouts_gloo{r}.npz") for r in range(4)]
    for name, spec in LAYOUT_RUNS.items():
        w, onebit = spec["warmup"], spec["compressor"] == "onebit"
        syncs = [bool(nccl[0][f"{name}__s{t}_sync"])
                 for t in range(spec["steps"])]
        if spec["optimizer"] == "zerone_adam":
            assert syncs == ZERONE_SYNCS, (name, syncs)
        for t in range(spec["steps"]):
            key = f"{name}__s{t}"
            launches = nccl[0][key + "_launches"].tolist()
            want = [1, 0, 0] if t < w else \
                [0, 2, 2] if onebit and syncs[t] else [0, 0, 0]
            assert launches == want, (key, launches)
            for r in range(4):
                np.testing.assert_array_equal(nccl[r][key + "_x"],
                                              nccl[0][key + "_x"])
                for k in gloo[r].files:
                    if k.startswith(key + "_"):
                        np.testing.assert_array_equal(
                            nccl[r][k], gloo[r][k], err_msg=f"{k} rank {r}")


# full-width BERT-Large training under the local layout and with zero1
# compressed steps on four NCCL cards (16 x 128 a rank)
FOUR_CARD_LAYOUTS = {
    "zerone_local": dict(FOUR_CARD, steps=8, topology="flat", n_buckets=1,
                         overlap=False, optimizer="zerone_adam",
                         layout="local", opt_kwargs=ZERONE),
    "onebit_zero1": dict(FOUR_CARD, topology="flat", n_buckets=1,
                         overlap=False, zero1=True)}


def test_nccl_local_and_zero1_training(card, tmp_path):
    """Full-width BERT-Large through ``train_step`` on a 2 x 2 NCCL mesh:
    0/1 Adam under the ``local`` layout (3 + 5 steps, the 0-bit step
    launching no exchange kernel) and 1-bit Adam whose compressed steps
    run under zero1 (3 + 3).  Losses are finite, the parameters are
    bitwise equal across the ranks, and each step launches 1 / 0 / 0
    kernels in warmup, 0 / 2 / 2 on a sync step, none on a 0-bit step.
    Prints each run's step walls."""
    import json
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    _four_cards()
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(FOUR_CARD_LAYOUTS, f)
    mp.start_processes(hw.steps_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [np.load(tmp_path / f"steps{r}.npz") for r in range(4)]
    for name, spec in FOUR_CARD_LAYOUTS.items():
        w = spec["warmup"]
        for r, got in enumerate(ranks):
            assert np.isfinite(got[f"{name}__loss"]).all(), (name, r)
            assert got[f"{name}__x"].tolist() == \
                ranks[0][f"{name}__x"].tolist(), (name, r)
            syncs = got[f"{name}__sync"].tolist()
            if name == "zerone_local":
                assert syncs == ZERONE_SYNCS, syncs
            launches = got[f"{name}__launches"].tolist()
            assert launches == [[1, 0, 0]] * w + [
                [0, 2, 2] if s else [0, 0, 0] for s in syncs[w:]], \
                (name, r, launches)
        print(f"[nccl4] {name}: step ms by rank "
              + json.dumps([got[f"{name}__ms"].round(1).tolist()
                            for got in ranks])
              + f"; losses {ranks[0][name + '__loss'].tolist()}")


def test_nccl_checkpoint_resume_bitwise(card, tmp_path):
    """A checkpoint saved at step 4 of full-width BERT-Large 1-bit Adam on
    a 2 x 2 NCCL mesh (rank 0 gathers every rank's slots), resumed to step
    6 serially and with 2 buckets: on every rank the resumed steps'
    losses, the parameters and every state slot are bitwise the
    uninterrupted run with the same bucket count (SHA-256 of each; the
    chunk slots are keyed by bucket), and the uninterrupted runs with 1
    and 2 buckets agree bitwise on the losses, parameters, ``m``, ``v``
    and ``worker_err``.  Prints the checkpoint's bytes, its save and load
    seconds and the step walls."""
    import json
    import os
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    _four_cards()
    path = str(tmp_path / "c.npz")
    base = dict(arch="bert-large", recipe="onebit_adam", warmup_steps=3,
                batch=64, seq=128, block_size=4096, mesh="2x2x1",
                digest=True)
    runs = {"full": dict(base, steps=6),
            "full2": dict(base, steps=6, pipeline=2),
            "first": dict(base, steps=4, ckpt=path),
            "off": dict(base, steps=6, resume=path),
            "two": dict(base, steps=6, resume=path, pipeline=2)}
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(runs, f)
    mp.start_processes(hw.run_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [np.load(tmp_path / f"run{r}.npz") for r in range(4)]
    assert str(ranks[0]["two__plan"]) == "pipe(flat/onebit)x2"
    slots = [k[len("full__"):] for k in ranks[0].files
             if k.startswith("full__opt_")]
    assert "opt_worker_err" in slots and "opt_server_err" in slots
    for r, got in enumerate(ranks):
        assert np.isfinite(got["full__loss"]).all()
        np.testing.assert_array_equal(got["first__loss"],
                                      got["full__loss"][:4])
        np.testing.assert_array_equal(got["full2__loss"], got["full__loss"])
        for k in ("x", "opt_m", "opt_v", "opt_worker_err"):
            assert str(got[f"full2__{k}"]) == str(got[f"full__{k}"]), (k, r)
        for run, want in (("off", "full"), ("two", "full2")):
            np.testing.assert_array_equal(got[f"{run}__loss"],
                                          got[f"{want}__loss"][4:],
                                          err_msg=f"{run} rank {r}")
            for k in ["x"] + slots:
                assert str(got[f"{run}__{k}"]) == str(got[f"{want}__{k}"]), \
                    (run, k, r)
    print(f"[nccl4] checkpoint: {os.path.getsize(path)} bytes, saved in "
          f"{float(ranks[0]['first__save_s']):.1f} s, loaded in "
          + ", ".join(f"{float(g['off__load_s']):.1f}" for g in ranks)
          + " s (serial resume, by rank), "
          + ", ".join(f"{float(g['two__load_s']):.1f}" for g in ranks)
          + " s (2 buckets); step ms "
          + "; ".join(f"{run} " + json.dumps(
              ranks[0][f"{run}__ms"].round(1).tolist()) for run in runs))


def test_nccl_comm_sweep_fits_the_intra_link(card, tmp_path):
    """``benchmarks.comm_sweep`` over NCCL on one pod of four cards: NCCL
    ``all_reduce`` and ``reduce_scatter`` timed at 4 KiB .. 64 MiB fit
    (ov, α, β) of the intra link (one pod: no cross link), and
    ``ClusterSpec.from_measured`` loads the JSON, or refuses it when the
    fit clamped a term.  Prints the fit and the samples: a measurement,
    not a gate on the card's numbers."""
    import json
    from repro_torch.benchmarks import comm_sweep
    from repro_torch.plan.cost import ClusterSpec
    _four_cards()
    path = str(tmp_path / "links.json")
    out = comm_sweep.run("4", device="cuda", json_path=path)
    assert out["cross"] is None and (out["n_inner"], out["n_outer"]) == \
        (4, 1)
    assert len(out["samples"]) == 2 * len(comm_sweep.SIZES)
    assert all(s["seconds"] > 0 for s in out["samples"])
    if out["clamped"]:
        with pytest.raises(ValueError, match="clamped"):
            ClusterSpec.from_measured(path)
    else:
        spec = ClusterSpec.from_measured(path)
        assert spec.intra == spec.cross and spec.n_inner == 4
    print(f"[nccl4] comm_sweep intra: alpha {out['intra']['latency']:.6e} "
          f"s, beta {out['intra']['bandwidth']:.6e} B/s, op_overhead "
          f"{out['op_overhead']:.6e} s, clamped {out['clamped']}; samples "
          + json.dumps([[s["op"], s["nbytes"], s["seconds"]]
                        for s in out["samples"]]))


def test_nccl_comm_volume_check_plans(card):
    """``benchmarks.comm_volume --check-plans`` over NCCL on four cards
    (2 x 2): for every compressor, flat over 4, hier 2 x 2 and both with 2
    and 4 buckets, ``hlo_bytes()`` equals the bytes handed to NCCL on
    every rank, exactly."""
    from repro_torch.benchmarks import comm_volume
    _four_cards()
    table = comm_volume.check_plans(device="cuda")
    assert len(table) == 18 and all(r["match"] for r in table.values())


def test_nccl_auto_schedule_bitwise_explicit(card, tmp_path):
    """``run`` at full BERT-Large on a 2 x 2 NCCL mesh (16 x 128 a rank,
    3 + 3 steps) with ``topology``, ``pipeline`` and ``overlap_bwd``
    ``"auto"`` on ``ethernet-10g`` and the ``h100-sxm`` spec takes the
    tuner's pick, and on every rank its losses, parameters and state are
    bitwise the explicit run's with the picked values (SHA-256 of each).
    Prints the pick, the step walls, and the stage 0s issued inside
    backward: measured (``TrainState.stage0_in_bwd``) against the count
    the priced ready times imply (ravel order taken as layer order)."""
    import json
    import torch.multiprocessing as mp
    import _torch_hier_worker as hw
    from repro_torch.configs import get_config
    from repro_torch.launch.train import resolve_schedule
    _four_cards()
    base = dict(arch="bert-large", recipe="onebit_adam", steps=6,
                warmup_steps=3, batch=64, seq=128, block_size=4096,
                mesh="2x2x1", digest=True)
    topo, nb, ob, tuned = resolve_schedule(
        "auto", "auto", "auto", cluster="ethernet-10g",
        cfg=get_config("bert-large"), dp_sizes=(2, 2), block_size=4096,
        device_spec="h100-sxm", batch=64, seq=128)
    runs = {"auto": dict(base, topology="auto", pipeline="auto",
                         overlap_bwd="auto"),
            "explicit": dict(base, topology=topo, pipeline=str(nb),
                             overlap_bwd="on" if ob else "off")}
    with open(tmp_path / "runs.json", "w") as f:
        json.dump(runs, f)
    mp.start_processes(hw.run_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [np.load(tmp_path / f"run{r}.npz") for r in range(4)]
    ready = tuned.best.ready_times
    priced = sum(r < max(ready) for r in ready) if ready else 0
    for r, got in enumerate(ranks):
        assert str(got["auto__plan"]) == str(got["explicit__plan"]), r
        assert np.isfinite(got["auto__loss"]).all()
        np.testing.assert_array_equal(got["auto__loss"],
                                      got["explicit__loss"])
        for k in [k[len("auto__"):] for k in got.files
                  if k.startswith("auto__opt_")] + ["x"]:
            assert str(got[f"auto__{k}"]) == str(got[f"explicit__{k}"]), \
                (k, r)
    print(f"[nccl4] auto schedule: {topo} x {nb} bucket(s), overlap "
          f"{'on' if ob else 'off'} ({ranks[0]['auto__plan']}); stage 0s "
          f"inside backward measured "
          f"{ranks[0]['auto__stage0_in_bwd'].tolist()}, priced {priced} a "
          f"step; step ms auto "
          + json.dumps([g["auto__ms"].round(1).tolist() for g in ranks])
          + " explicit "
          + json.dumps([g["explicit__ms"].round(1).tolist() for g in ranks]))


def test_nccl_obs_profile_and_drift(card, tmp_path):
    """The launcher's observability over NCCL on 4 cards: ``torchrun`` of
    ``repro_torch.launch.train`` at full BERT-Large on a 2 x 2 mesh, hier,
    2 buckets, backward overlap, with ``--telemetry``, ``--profile`` (the
    last 2 steps), ``--drift-probe`` and ``--memory on``.  On every rank
    the log validates, its ``profile`` event has a cell for every
    (bucket, stage) op of ``pipe(hier/onebit)x2`` with the NCCL kernels as
    wire time and ``t_attributed + t_residual == t_window`` (to rounding,
    1e-12 s), and the ``drift`` events, one per (kind, tier) of the
    probed plan with 3 samples each, validate.  Prints each rank's
    attributed share, comm fraction and drift ratios."""
    import json
    import os
    import subprocess
    import sys
    from repro_torch.configs import get_config
    from repro_torch.obs.events import validate_records
    from repro_torch.obs.profile import cell_key, parse_scope
    from repro_torch.optim import get_compressor
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.pipeline.executor import scoped_op_names
    from repro_torch.plan import hier_schedule
    from repro_torch.train.step import flat_dim
    _four_cards()
    tel, prof = str(tmp_path / "tel"), str(tmp_path / "prof")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "bert-large", "--mesh", "2x2x1", "--topology", "hier",
         "--pipeline", "2", "--overlap-bwd", "on", "--steps", "6",
         "--warmup-steps", "3", "--batch", "64", "--seq", "128",
         "--telemetry", tel, "--profile", prof, "--profile-steps", "2",
         "--drift-probe", "--memory", "on", "--bench", "nccl4"],
        env=dict(os.environ, PYTHONPATH=os.path.abspath(src)),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    d = flat_dim(get_config("bert-large"), 4, 4096)
    comp = get_compressor("onebit", block_size=4096)
    pplan = lower_to_pipelined(
        hier_schedule(comp, d, 2, 2, ("data",), ("pod",), outer_ef=False),
        comp, Bucketer.for_exchange(d, 4, 4096, 2))
    want = {cell_key(parse_scope(n)) for n in scoped_op_names(pplan)}
    for r in range(4):
        name = "telemetry.jsonl" if r == 0 else f"telemetry_rank{r}.jsonl"
        with open(os.path.join(tel, name)) as f:
            recs = [json.loads(ln) for ln in f]
        validate_records(recs)
        [p] = [x for x in recs if x["type"] == "profile"]
        cells = {(c["plan"], c["bucket"], c["stage"], c["kind"],
                  c["tier"]): c for c in p["cells"]}
        assert want <= set(cells), (r, sorted(want - set(cells)))
        assert all(cells[k]["t_wire"] > 0 for k in want), r
        assert p["t_attributed"] > 0
        assert abs(p["t_attributed"] + p["t_residual"] - p["t_window"]) \
            <= 1e-12
        drift = [x for x in recs if x["type"] == "drift"]
        assert {(x["op_kind"], x["tier"]) for x in drift} == {
            ("AllToAll", "intra"), ("AllToAll", "cross"),
            ("AllGather", "cross"), ("AllGather", "intra")}, r
        assert all(x["n_samples"] == 3 for x in drift), r
        print(f"[nccl4] obs rank {r}: attributed "
              f"{p['t_attributed'] / p['t_window']:.4f} of "
              f"{p['t_window']:.4f} s, comm_fraction "
              f"{p['comm_fraction']:.4f}, {p['n_cells']} cells; drift "
              + ", ".join(f"{x['op_kind']}~{x['tier']} x{x['ratio']:.2f}"
                          for x in drift))


def test_nccl_seq_sharded_decode_matches_one_card(card, tmp_path):
    """Seq-sharded (flash-decoding) decode over NCCL on 4 cards:
    jamba-smoke in f32, B 1, S 64 (16 slots a card), steps at positions
    0-4 and 14-17 (the owner shard moves from card 0 to card 1), through
    ``make_serve_step``; every card's logits equal one card's unsharded
    decode at 2e-4 (the tolerance of the reference's seq-sharded test)."""
    import torch.multiprocessing as mp
    import _torch_serve_worker as worker
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import DpMesh
    from repro_torch.models import transformer as TT
    from repro_torch.train.step import make_serve_step
    _four_cards()
    arch = "jamba-1.5-large-398b-smoke"
    cfg = get_config(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    case = dict(arch=arch, dtype="float32", batch=1, seq=64,
                positions=[0, 1, 2, 3, 4, 14, 15, 16, 17])
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (1, len(case["positions"]))).astype(np.int32)
    worker.write_case(tmp_path, case, params, tokens)
    mp.start_processes(worker.decode_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [np.load(tmp_path / f"decode_nccl{r}.npz") for r in range(4)]
    step = make_serve_step(cfg, DpMesh(axes=("dp",), sizes=(1,), groups={}),
                           InputShape("d", 64, 1, "decode"), device="cuda")
    caches = step.init_caches(dtype=torch.float32)
    on_card = {k: v.to(card) for k, v in params.items()}
    assert all(bool(r["seq_sharded"]) for r in ranks)
    err = 0.0
    for i, pos in enumerate(case["positions"]):
        want, caches = step(on_card, {"tokens": torch.from_numpy(
            tokens[:, i:i + 1])}, caches, pos)
        want = want.float().cpu().numpy()
        for r in ranks:
            np.testing.assert_allclose(r[f"s{i}"], want, rtol=2e-4,
                                       atol=2e-4)
            err = max(err, float(np.abs(r[f"s{i}"] - want).max()))
    print(f"[nccl4] seq-sharded decode, 4 cards vs one: "
          f"{len(case['positions'])} steps, max abs err {err:.3e}")


def test_nccl_overlap_check_and_comm_volume_harness(card, tmp_path):
    """The harness (``benchmarks.run``) over NCCL on four cards:
    ``overlap_check`` traces one pipelined hier exchange (2 x 2 mesh, 2
    buckets) on every rank, finds NCCL kernels, and at least one of them
    runs under a kernel on another stream (the check raises otherwise);
    ``comm_volume`` holds every plan's bytes to the bytes handed to NCCL.
    Both results go through ``--json``'s writer and are read back.  Then
    ``overlap_check`` again at BERT-Large's d_pad (block 4096, the size
    the training path exchanges), where the compress kernels take
    milliseconds.  Prints the cards, and for each run and NCCL kernel its
    time and the part of it under compute kernels and under other NCCL
    kernels on another stream."""
    import json
    from repro_torch.benchmarks import run as harness
    from repro_torch.obs.bench import load_ledger
    _four_cards()
    out = harness.run_benchmarks(["comm_volume", "overlap_check"], "cuda")
    oc = out["overlap_check"]
    assert oc["mesh"] == [2, 2] and oc["collectives"] > 0
    assert 0 < oc["overlapped"] <= oc["collectives"]
    assert len(out["comm_volume"]) == 18
    assert all(r["match"] for r in out["comm_volume"].values())
    path = str(tmp_path / "BENCH_all.json")
    harness.write_json(path, out, list(out), "cuda")
    assert len(load_ledger(path)["records"]) >= 18
    import subprocess
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", " | ")
    print(f"[nccl4] cards: {card_line}")
    from repro_torch.benchmarks import overlap_check
    from repro_torch.configs import get_config
    from repro_torch.train.step import flat_dim

    def report(tag, r, block):
        print(f"[nccl4] overlap_check {tag} (d {r['d']}, block {block}): "
              f"{r['overlapped']} of {r['collectives']} NCCL kernels under "
              f"another stream, {r['overlapped_compute']} under compute, "
              f"{r['overlapped_nccl']} under NCCL; kernels [rank, name, us, "
              "under compute us, under NCCL us] "
              + json.dumps([[x["rank"], x["kernel"], round(x["us"], 2),
                             round(x["hidden_compute_us"], 2),
                             round(x["hidden_nccl_us"], 2)]
                            for x in r["details"]]))
    report("d_default", oc, 512)
    big = overlap_check.run((2, 2), d=flat_dim(get_config("bert-large"), 4,
                                               4096), block=4096)
    report("d_bert_large", big, 4096)
    assert big["collectives"] > 0 and big["overlapped"] > 0


# full-width BERT-Large, 2 x 2 dp, 2 buckets with backward overlap; the
# profile holds the last 2 steps, compressed ones only
OVERLAP_BWD_RUN = dict(arch="bert-large", mesh="2x2x1", pipeline="2",
                       overlap_bwd="on", batch=16, seq=128, block_size=4096,
                       steps=5, warmup_steps=3, profile_steps=2)


def test_nccl_overlap_check_bwd(card, tmp_path):
    """``overlap_check --bwd`` over NCCL on four cards.  (a) ``run_bwd``
    at the reference's micro sizes (4 layers of width 64, 2 buckets,
    block 512, one rank a card): NCCL kernels found, and at least one
    issued between backward matmuls (``run_bwd`` raises otherwise).
    (b) full BERT-Large through ``launch.train.run`` on a 2 x 2 dp mesh,
    2 buckets, backward overlap, bf16, batch 16 x 128, 3 warmup steps
    then 2 compressed ones under ``--profile`` (one rank a card, spawned):
    on every rank ``check_bwd_trace(load_profile_dir(prof, rank))`` finds
    the first stage's all_to_all of at least one bucket issued between
    backward matmuls, and each rank launches ``adam_step`` once a warmup
    step and ``ef_compress`` / ``decompress`` twice a bucket and
    compressed step.  Prints, for each rank, ``pairs``,
    ``overlapped_bwd``, the NCCL µs under backward matmuls beside the
    NCCL µs in all, and ``stage0_in_bwd`` beside the count the cost
    model's ready times price."""
    import json
    import subprocess
    import torch.multiprocessing as mp
    import _torch_overlap_bwd_worker as worker
    from repro_torch.benchmarks.overlap_check import (check_bwd_trace,
                                                      run_bwd)
    from repro_torch.configs import get_config
    from repro_torch.launch.train import plan_ready_times
    from repro_torch.obs.profile import load_profile_dir
    from repro_torch.perf.device import get_device
    _four_cards()
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", " | ")
    print(f"[nccl4] cards: {card_line}")

    def summary(r):
        return {k: r[k] for k in ("pairs", "overlapped_bwd", "n_dots",
                                  "issued", "device_overlapped")} | {
            "nccl_us": round(r["nccl_us"], 1),
            "nccl_under_dots_us": round(r["nccl_under_dots_us"], 1)}

    a = run_bwd((4,), block=512, n_buckets=2)
    assert a["pairs"] > 0 and a["overlapped_bwd"] > 0
    print("[nccl4] overlap_bwd micro: " + json.dumps(
        {"total": summary(a), "ranks": [summary(r) for r in a["ranks"]],
         "kernels": [[x["rank"], x["kind"], x["index"], x["dots_before"],
                      x["dots_after"], round(x["us"], 1),
                      round(x["under_dots_us"], 1), x["device_dots_after"]]
                     for x in a["details"]]}))
    mp.start_processes(worker.train_main,
                       args=(4, str(tmp_path), OVERLAP_BWD_RUN), nprocs=4,
                       start_method="spawn")
    run = OVERLAP_BWD_RUN
    warm, comp = run["warmup_steps"], run["steps"] - run["warmup_steps"]
    cfg = get_config(run["arch"])
    rows = []
    for r in range(4):
        with open(tmp_path / f"train{r}.json") as f:
            res = json.load(f)
        nb = res["n_buckets"]
        want = {"adam_step": warm, "ef_compress": 2 * nb * comp,
                "decompress": 2 * nb * comp}
        assert {k: res["launches"][k] for k in want} == want, (r, res)
        ready, _ = plan_ready_times(cfg, res["d_pad"], 4, run["block_size"],
                                    nb, get_device("h100-sxm"),
                                    run["batch"], run["seq"])
        priced = sum(t < max(ready) for t in ready)
        events = load_profile_dir(str(tmp_path / "prof"), r)
        b = check_bwd_trace(events)
        if r == 0:
            cats = {}
            for e in events:
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            nccl = [e for e in events if e.get("cat") == "kernel"
                    and "nccl" in str(e.get("name", "")).lower()][:1]
            print("[nccl4] overlap_bwd trace of rank 0: categories "
                  + json.dumps(cats) + "; an NCCL kernel "
                  + json.dumps(nccl, default=str)[:600])
        a2a = [x for x in b["details"] if x["kind"] == "all-to-all"]
        rows.append(dict(summary(b), rank=r,
                         backward_passes=b["backward_passes"],
                         all_to_all_overlapped=sum(x["overlapped_bwd"]
                                                   for x in a2a),
                         streams=b["streams"],
                         stage0_in_bwd=[h["stage0_in_bwd"]
                                        for h in res["history"][warm:]],
                         priced=priced,
                         step_ms=[round(h["ms"], 1) for h in res["history"]
                                  if h.get("ms") is not None],
                         kernels=[[x["kind"], x["index"], x["dots_before"],
                                   x["dots_after"], round(x["us"], 1),
                                   round(x["under_dots_us"], 1),
                                   x["device_dots_after"]]
                                  for x in b["details"]]))
    print("[nccl4] overlap_bwd bert-large: " + json.dumps(rows))
    for row in rows:
        assert row["backward_passes"] == comp, row["rank"]
        assert row["all_to_all_overlapped"] >= 1, row


# --------------------------------------------------------------------------
# tensor, sequence and expert parallelism over NCCL (four cards)
# --------------------------------------------------------------------------

def test_nccl_tp_sp_reduced_parity(card, tmp_path):
    """The reduced configs on a 2 x 2 (dp x model) mesh of four NCCL
    ranks, in f32 with TF32 off, each rank on its dp half of one batch:
    the TP model's loss and every leaf of each rank's gradient shard
    against one card's tp = 1 model of the same global params (loss rtol
    1e-5, gradient max-relative error 1e-4, the reference's TP-parity
    tolerances; MoE capacity factor 64, so no token drops), and the
    sequence-parallel model against the TP one at the reference's SP
    tolerances (1e-5 dense, SSM and VLM; 0.2 MoE)
    (``_torch_tp_worker.reduced_parity``)."""
    import _torch_tp_worker as worker
    _four_cards()
    worst = worker.reduced_parity(tmp_path, 4, "nccl", card)
    print(f"[tp4] reduced TP vs one card / SP vs TP max-rel errors: "
          f"{worst}")


# paths A and B of the tensor-parallel slice at full width
TP_PATHS = {
    "A": dict(base="internlm2-1.8b", name="internlm2-1.8b-tp", cfg={},
              mesh="2x2", seed=0, parity=dict(batch=2, seq=2048),
              run=dict(steps=20, warmup_steps=10, batch=16, seq=2048,
                       block_size=4096, lr=1e-4, lr_warmup=0)),
    "B": dict(base="mixtral-8x22b", name="mixtral-8x22b-1l",
              cfg={"n_layers": 1}, mesh="1x4", seed=0,
              # capacity factor E / k = 4: an expert's buffer holds every
              # token, so nothing drops on either side
              parity=dict(batch=1, seq=2048,
                          cfg={"capacity_factor": 4.0}),
              run=dict(steps=4, warmup_steps=2, batch=8, seq=2048,
                       block_size=4096, lr=1e-4, lr_warmup=0)),
}


# path A with remat_policy="dots": the same steps, run beside path A
TP_PATHS["A_dots"] = dict(TP_PATHS["A"], name="internlm2-1.8b-tp-dots",
                          cfg={"remat_policy": "dots"})


# path A with the dp exchange in two buckets issued from backward hooks
# (beside the model group's collectives), and its serial twin
TP_PATHS["A_overlap"] = dict(
    TP_PATHS["A"], profile=False,
    run=dict(TP_PATHS["A"]["run"], steps=4, warmup_steps=2, pipeline=2,
             overlap_bwd="on"),
    twin={"overlap_bwd": "off"})


def _tp_path(tmp_path, which):
    import json
    import subprocess
    import torch.multiprocessing as mp
    import _torch_tp_worker as worker
    from repro_torch.configs import get_config
    _four_cards()
    spec = TP_PATHS[which]
    with open(tmp_path / "card.json", "w") as f:
        json.dump(spec, f)
    mp.start_processes(worker.card_main, args=(4, str(tmp_path), "nccl"),
                       nprocs=4, start_method="spawn")
    ranks = [json.load(open(tmp_path / f"card_r{r}.json")) for r in range(4)]
    summary = {k: ranks[0][k] for k in (
        "loss_tp1", "loss_tp", "rerouted_tokens", "routed_tokens",
        "losses", "stages", "step_ms", "launches", "d", "d_pad",
        "flat_size_tp1", "wire_bytes", "replicated_leaves_max_drift",
        "parity_tp1_s", "parity_tp_s", "run_s", "n_buckets",
        "overlap_bwd") if k in ranks[0]}
    summary.update({k: ranks[0][k] for k in (
        "profile", "twin_losses", "twin_step_ms", "twin_bitwise")
        if k in ranks[0]})
    summary["cards"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", " | ")
    summary["grad_max_rel_err"] = max(r["grad_max_rel_err"] for r in ranks)
    summary["rerouted_ranks"] = [r["rerouted_tokens"] for r in ranks]
    summary["peak_gb"] = [r["peak_bytes"] / 1e9 for r in ranks]
    summary["profile_ranks"] = [r.get("profile") for r in ranks]
    print(f"[tp4] path {which}: " + json.dumps(summary))
    moe = bool(get_config(spec["base"]).n_experts)
    for r in ranks:
        # the MoE spy saw every token of the batch; a routing fault under
        # TP (a wrong expert block or router shard) reroutes many tokens,
        # which the parity would then hold out of the loss: only near
        # ties may flip, at most 10 of the 2,048 (about 0.5 %)
        assert (r["routed_tokens"] > 0) == moe, r["routed_tokens"]
        assert r["rerouted_tokens"] <= 10, r["rerouted_tokens"]
        np.testing.assert_allclose(r["loss_tp"], r["loss_tp1"], rtol=1e-5)
        assert r["grad_max_rel_err"] < 1e-4, r["grad_max_rel_err"]
        assert np.isfinite(r["losses"]).all()
        assert r["dp_replicas_bitwise"]
        assert r["launches"]["adam_step"] == spec["run"]["warmup_steps"]
    return ranks


def test_nccl_tp_path_a_internlm2(card, tmp_path):
    """Path A: full internlm2-1.8b (24 layers, d 2048) on a 2 x 2 (dp x
    model) mesh of four cards, 1-bit Adam through ``launch.train.run``:
    step 0 in f32 (TF32 off) against the tp = 1 model of the same global
    params on each card (loss rtol 1e-5, gradient shard max-relative error
    1e-4); then 10 warmup + 10 compressed steps in bf16, batch 8 x 2048 a
    dp rank: the dp replicas bitwise, one fused Adam launch a warmup step
    and two ef_compress / decompress launches a compressed step."""
    ranks = _tp_path(tmp_path, "A")
    for r in ranks:
        assert r["launches"]["ef_compress"] == 2 * 10
        assert r["launches"]["decompress"] == 2 * 10
        assert r["losses"][-1] < r["losses"][0]


def test_nccl_tp_path_a_dots_beside_block(card, tmp_path):
    """Path A twice, each in processes of their own (so each profile is
    its process's first): whole-block recompute, then
    ``remat_policy="dots"``.  Under "dots" the step-0 parity holds as in
    path A, the launches are path A's, and step 0's loss is bitwise the
    "block" run's on every rank; prints the step ms, peak a card, kernels
    a step and idle share of both."""
    import json
    runs = {}
    for which in ("A", "A_dots"):
        (tmp_path / which).mkdir()
        runs[which] = _tp_path(tmp_path / which, which)
    side = {}
    for which, ranks in runs.items():
        side[which] = {
            "losses": ranks[0]["losses"],
            "step_ms": [r["step_ms"] for r in ranks],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
            "profile": [r.get("profile") for r in ranks],
            "launches": ranks[0]["launches"]}
    side["losses_bitwise"] = [a["losses"] == b["losses"] for a, b in
                              zip(runs["A"], runs["A_dots"])]
    print("[tp4] path A block vs dots: " + json.dumps(side))
    for block, dots in zip(runs["A"], runs["A_dots"]):
        assert dots["losses"][0] == block["losses"][0]
        assert dots["launches"] == block["launches"]


def test_nccl_tp_path_b_mixtral(card, tmp_path):
    """Path B: mixtral-8x22b at full width cut to one layer (2.9 B
    parameters) on a 1 x 4 mesh: 2 experts, 12 q and 2 kv heads a card;
    step 0 in f32 against the tp = 1 layer on each card (a token routed
    to another expert on the two sides, a near tie broken the other way,
    is counted and held out of the loss: with one layer only its own
    loss term reads its output), then 2 warmup + 2 compressed steps in
    bf16, batch 8 x 2048."""
    _tp_path(tmp_path, "B")


def test_nccl_tp_path_a_overlap_bitwise_serial(card, tmp_path):
    """Path A with ``pipeline=2, overlap_bwd="on"``: the dp exchange's two
    buckets issue from backward hooks on their own stream beside the model
    group's all-reduces in backward (two NCCL communicators, each in one
    order on every rank); step 0's parity as in path A, then 2 warmup + 2
    compressed steps bitwise the same run with overlap off."""
    ranks = _tp_path(tmp_path, "A_overlap")
    for r in ranks:
        assert r["n_buckets"] == 2 and r["overlap_bwd"], r["n_buckets"]
        assert not r["twin_overlap_bwd"]
        assert r["twin_bitwise"], (r["losses"], r["twin_losses"])


# the tensor-parallel serving slice: the reduced families at 1 x 2, 1 x 4
# and 2 x 2 against one card's tp = 1, and path S
TP_SERVE_ARCHS = ["llama3.2-3b", "granite-34b", "falcon-mamba-7b",
                  "mixtral-8x22b", "jamba-1.5-large-398b", "internvl2-2b",
                  "musicgen-large"]
TP_SERVE_MESHES = {2: [(a, "1x2", False) for a in TP_SERVE_ARCHS],
                   4: [(a, "1x4", False) for a in TP_SERVE_ARCHS]
                   + [(a, "2x2", q) for a in ("llama3.2-3b",
                                              "falcon-mamba-7b")
                      for q in (False, True)]}
PATH_S = dict(arch="granite-34b", mesh="1x4", batch=8, prompt=2048,
              new_tokens=32, seed=0,
              parity=dict(layers=8, batch=2, prompt=512, steps=4, seed=1))


def test_nccl_tp_serve_reduced_parity(card, tmp_path):
    """The reduced decoding families through ``make_serve_step`` on NCCL
    ranks at 1 x 2, 1 x 4 and 2 x 2 (batch- and seq-sharded), in f32 with
    TF32 off: prefill logits (vocab shards joined), caches joined over
    both axes and 4 decode steps against one card's tp = 1 serving of the
    same model (rtol / atol 1e-4, seq-sharded 2e-4), held up to the first
    step where a MoE token routes differently
    (``_torch_tp_serve_worker``)."""
    import torch.multiprocessing as mp
    import _torch_tp_serve_worker as worker
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    _four_cards()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for world, cases in TP_SERVE_MESHES.items():
        workdir = tmp_path / f"w{world}"
        workdir.mkdir()
        refs, spec = {}, {}
        for arch, mesh, seq in cases:
            name = f"{arch}@{mesh}" + ("-seq" if seq else "")
            cfg = get_config(arch + "-smoke")
            tp = int(mesh.split("x")[-1])
            one = TT.init_params(cfg, torch.Generator().manual_seed(0))
            plan = worker.case_plan(cfg, seq)
            pre, steps = worker.make_inputs(
                cfg, 2 if seq else 1, plan["batch"], max(plan["prompt"], 1),
                len(plan["positions"]))
            ref = worker.port_reference(
                cfg, {k: v.to(card) for k, v in one.items()}, pre, steps,
                plan, card)
            refs[name] = dict(ref, pre=pre, steps=steps)
            pfile = f"params_{arch}_tp{tp}.npz"
            np.savez(workdir / pfile, **{
                k: v.numpy() for k, v in worker.expand_kv(one, cfg,
                                                          tp).items()})
            spec[name] = worker.write_inputs(
                str(workdir), name, dict(arch=arch, mesh=mesh,
                                         seq_sharded=seq), refs[name], pfile)
        worker.write_case(str(workdir), world, spec)
        mp.start_processes(worker.serve_main,
                           args=(world, str(workdir), "nccl"),
                           nprocs=world, start_method="spawn")
        for name, c in spec.items():
            ranks = [np.load(workdir / f"{name}_r{r}.npz")
                     for r in range(world)]
            tol = dict(rtol=2e-4, atol=2e-4) if c["seq_sharded"] else \
                dict(rtol=1e-4, atol=1e-4)
            counts, err = worker.check_case(
                refs[name], ranks, get_config(c["arch"]), c["mesh"],
                c["seq_sharded"], tol)
            report[name] = {"rerouted": counts, "max_abs_err": err}
            assert c["seq_sharded"] or counts[0] == 0, name
    print("[tp-serve] reduced families (rerouted MoE tokens a phase, max "
          "abs err against tp = 1): " + str(report))


def test_nccl_tp_serve_path_s_granite(card, tmp_path):
    """Path S: granite-34b at full size (88 layers, d 6144, 48 q / 1 kv
    heads, d_ff 24576, vocab 49152; 47.25 B parameters, 94.5 GB in bf16)
    on a 1 x 4 mesh in bf16 with attn_impl="pallas": batch 8 x prompt
    2048 through the prefill step (one wgmma flash launch a layer a
    rank), then 32 greedy decode steps, the same tokens on every rank;
    prefill ms, decode ms a step, tokens/s, peak bytes a card and one
    profiled decode step's kernels and idle share printed.  Before it,
    the model cut to 8 layers in f32 with TF32 off: the prefill's and 4
    decode steps' logits at tp 4 within 1e-4 of max |logit| of rank 0's
    tp = 1 model (``_torch_tp_serve_worker.path_s_main``)."""
    import json
    import subprocess
    import torch.multiprocessing as mp
    import _torch_tp_serve_worker as worker
    from repro_torch.configs import get_config
    _four_cards()
    with open(tmp_path / "path_s.json", "w") as f:
        json.dump(PATH_S, f)
    mp.start_processes(worker.path_s_main, args=(4, str(tmp_path)),
                       nprocs=4, start_method="spawn")
    ranks = [json.load(open(tmp_path / f"path_s_r{r}.json"))
             for r in range(4)]
    cfg = get_config(PATH_S["arch"])
    for p in ranks[0]["parity"]:
        assert p["max_abs_err"] <= 1e-4 * p["max_abs_logit"], p
    for r in ranks:
        assert r["prefill_finite"]
        assert r["prefill_launches"]["flash_attention_wgmma"] == \
            cfg.n_layers
        assert sum(r["prefill_launches"].values()) == cfg.n_layers
        assert r["tokens"] == ranks[0]["tokens"]
    b, n = PATH_S["batch"], PATH_S["new_tokens"]
    dec = sorted(ranks[0]["decode_ms"])
    med = dec[len(dec) // 2]
    summary = {
        "cards": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", " | "),
        "parity": ranks[0]["parity"], "parity_s": ranks[0]["parity_s"],
        "draw_s": ranks[0]["draw_s"],
        "rank_param_gb": ranks[0]["rank_param_bytes"] / 1e9,
        "prefill_ms": [r["prefill_ms"] for r in ranks],
        "prefill_tokens_per_s": b * PATH_S["prompt"]
        / (ranks[0]["prefill_ms"] / 1e3),
        "decode_ms_median": med, "decode_ms_min": dec[0],
        "decode_ms_max": dec[-1],
        "decode_tokens_per_s": b / (med / 1e3),
        "tokens_per_s": b * n / ((ranks[0]["prefill_ms"]
                                  + sum(ranks[0]["decode_ms"])) / 1e3),
        "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
        "profile": ranks[0]["profile"],
        "idle_share": [r["profile"]["idle_share"] for r in ranks]}
    print("[tp-serve] path S: " + json.dumps(summary))
