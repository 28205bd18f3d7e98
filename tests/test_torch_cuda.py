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
(``WIDE_TOL``).
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
