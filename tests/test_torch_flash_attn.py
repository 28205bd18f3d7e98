"""The port's flash-attention op against the JAX package's.

The same numpy inputs, made from a seed, go through the reference's
``repro.kernels.flash_attn.ops.flash_attention`` (the Pallas kernel in
interpret mode on the CPU) and the port's ``ops.flash_attention`` (on the
CPU: its plain version, ``ref.sdpa``), over the grid of S, D, causal,
window and blocks of ``tests/test_kernels.py``.  Tolerances are that
file's: f32 rtol 1e-5 / atol 2e-6 (the kernel's online softmax sums in
another order than one softmax), bf16 rtol 2e-2 / atol 2e-2 (one bf16
rounding of the output, on either side of a near-tie).

The CUDA wrapper's head-dim padding (a D without a kernel instance is
zero-padded to the next one, the scores scaled by the true D, the output
sliced back) runs here through the plain version and is held to the
reference at D = 48 and 80, in f32 and fp16 (fp16 rtol/atol 2e-3: one
fp16 rounding of the output on either side of a near-tie, two ulps at 1).

Head dims above 256 (the split kernel's wide route on the card, D
zero-padded to a multiple of 64) go the same way: the plain version at
D = 320, and the wrapper's padding at D = 300 (to 320), against the
reference's kernel on the unpadded input, in f32 and fp16.

The split kernel's arithmetic (``csrc/flash_attn_sm90_split.cu``, which
runs only on the card) is emulated here in plain f32 tensor code: its
tiles (128 query rows a CTA, 32 keys for f32, 64 for 16-bit) and loop
bounds,
the three-term bf16 split of f32 q, k, v and p with the six kept cross
products, x0y0 and the five small score products summed apart, a fresh
p v sum a tile added to o in f32, scores in log2 units; for 16-bit inputs
p in two terms of the input dtype.  It is held to the reference's kernel
in interpret mode: f32 at the f32 tolerance above, so the split alone
fits it; 16-bit at one output ulp (bf16 rtol 8e-3, fp16 1e-3, atol 1e-5:
the card's wide tolerance).

The wrapper's contract is checked as well: ValueError where the
reference asserts (S not a multiple of the clamped blocks), a CPU tensor
of any head dim refused by the CUDA wrapper for its device only (the
plain version takes it), and forward only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fa_ref  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=2e-6)
F16_TOL = dict(rtol=2e-3, atol=2e-3)
_TORCH_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype=None, **kw):
    jin = [jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)
           for a in arrays]
    want = np.asarray(jops.flash_attention(*jin, **kw), np.float32)
    tin = [torch.from_numpy(a) if dtype is None
           else torch.from_numpy(a).to(_TORCH_DTYPES[dtype]) for a in arrays]
    got = fa_ops.flash_attention(*tin, **kw)
    return got, want


def _padded_plain(q, k, v, causal, window, head_dim):
    return fa_ref.sdpa(q, k, v, causal=causal, window=window,
                       head_dim=head_dim)


@pytest.mark.parametrize("s,d,causal,blocks", [
    (128, 32, True, (64, 64)),
    (128, 64, False, (128, 64)),
    (256, 128, True, (128, 128)),
    (256, 32, False, (64, 64)),
    (512, 64, True, (128, 64)),
    (512, 128, False, (128, 128)),
])
def test_matches_reference(s, d, causal, blocks):
    arrays = _qkv(s + d, (1, 2, s, d))
    got, want = _both(arrays, causal=causal, bq=blocks[0], bk=blocks[1])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_sliding_window(window):
    arrays = _qkv(window, (1, 2, 256, 64))
    got, want = _both(arrays, causal=True, window=window, bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_bf16():
    arrays = _qkv(3, (2, 2, 128, 64))
    got, want = _both(arrays, dtype=jnp.bfloat16, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2e-2, atol=2e-2)


def test_default_blocks_clamp_to_s():
    """bq/bk default to 256 and are clamped to S, so S = 96 is valid."""
    arrays = _qkv(5, (1, 2, 96, 32))
    got, want = _both(arrays, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("s,bq,bk", [(384, None, None), (128, 96, None),
                                     (128, 64, 48)])
def test_raises_where_the_reference_asserts(s, bq, bk):
    q = torch.zeros(1, 1, s, 32)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q, q, q, bq=bq, bk=bk)
    with pytest.raises(AssertionError):
        jq = jnp.zeros((1, 1, s, 32))
        jops.flash_attention(jq, jq, jq, bq=bq, bk=bk)


def test_unsupported_head_dim_raises_on_cuda_only():
    """The CUDA wrapper takes every head dim >= 1 (D = 48 zero-padded to
    64, D = 300 to 320 for the wide instance), so a CPU tensor is refused
    only for its device, whatever its D; D = 0 is refused for itself.
    The CPU path computes D = 48 (the plain version takes any D)."""
    arrays = _qkv(7, (1, 2, 64, 48))
    got, want = _both(arrays, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    q = torch.from_numpy(arrays[0])
    big = torch.zeros(1, 1, 8, 300)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for t in (q, big):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fa_kernel.flash_attention(t.to(dtype), t.to(dtype),
                                          t.to(dtype))
    assert [fa_kernel.kernel_head_dim(300, dt) for dt in
            (torch.float32, torch.bfloat16, torch.float16)] == [320] * 3
    assert fa_kernel.kernel_head_dim(1000, torch.float32) == 1024
    # f32 takes the split kernel at every D (a multiple of 64), 16-bit the
    # wgmma kernel's instances up to 256
    assert [fa_kernel.kernel_head_dim(d, torch.float32)
            for d in (1, 32, 48, 80, 128, 200, 256)] == [64, 64, 64, 128,
                                                         128, 256, 256]
    assert [fa_kernel.kernel_head_dim(d, torch.float16)
            for d in (1, 48, 80, 200)] == [64, 64, 128, 256]
    with pytest.raises(ValueError, match="head dim 0"):
        fa_kernel.kernel_head_dim(0, torch.float32)


@pytest.mark.parametrize("d,dtype,causal,window", [
    (48, None, True, None),
    (80, None, False, None),
    (48, jnp.float16, True, None),
    (80, jnp.float16, True, 64),
    (300, None, True, None),
    (300, jnp.float16, False, 64),
])
def test_padded_head_dim_matches_reference(d, dtype, causal, window):
    """The CUDA wrapper's pad / true-D scale / slice, through the plain
    version, against the reference's kernel on the unpadded input."""
    arrays = _qkv(d + 1, (1, 2, 128, d))
    jin = [jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)
           for a in arrays]
    want = np.asarray(jops.flash_attention(*jin, causal=causal,
                                           window=window, bq=64, bk=64),
                      np.float32)
    tdt = torch.float32 if dtype is None else _TORCH_DTYPES[dtype]
    tin = [torch.from_numpy(a).to(tdt) for a in arrays]
    assert fa_kernel.kernel_head_dim(d, tdt) > d
    got = fa_kernel.with_padded_head_dim(_padded_plain, *tin, causal,
                                         window)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype is None else F16_TOL))


@pytest.mark.parametrize("dtype,causal,window", [
    (None, True, None), (None, False, 32), (jnp.float16, True, None)])
def test_wide_head_dim_matches_reference(dtype, causal, window):
    """D = 320, past the 256 of the tile kernels: the plain version (the
    CPU path) against the reference's kernel in interpret mode."""
    arrays = _qkv(320, (1, 2, 128, 320))
    got, want = _both(arrays, dtype=dtype, causal=causal, window=window,
                      bq=64, bk=64)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype is None else F16_TOL))


def test_forward_only_and_cpu_counts_no_launch():
    q = torch.randn(1, 1, 64, 32, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        fa_ops.flash_attention(q, q, q)
    before = build.launch_counts()
    with torch.no_grad():
        out = fa_ops.flash_attention(q, q, q)
        fa_ops.flash_attention(q.to(torch.bfloat16), q.to(torch.bfloat16),
                               q.to(torch.bfloat16))
    torch.testing.assert_close(out, fa_ref.sdpa(q.detach(), q.detach(),
                                                q.detach()))
    assert build.launch_counts() == before


# --- the split kernel's arithmetic, emulated -------------------------------

_LOG2E = 1.4426950408889634
# (a, b) term pairs of the five small cross products, smallest first; the
# kernel issues x0y0 apart
_SMALL = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1))
WIDE_TOL = {jnp.bfloat16: dict(rtol=8e-3, atol=1e-5),
            jnp.float16: dict(rtol=1e-3, atol=1e-5)}


def _terms(x, n, dtype):
    """f32 x -> n f32 tensors holding ``dtype`` values, term t the
    round-to-nearest of what terms 0..t-1 leave."""
    out = []
    for _ in range(n):
        t = x.to(dtype).to(torch.float32)
        out.append(t)
        x = x - t
    return out


def _split_flash(q, k, v, causal, window, head_dim, dtype):
    """The split kernel on (BH, S, D) inputs of ``dtype``, in f32 on the
    CPU: f32 -> three bf16 terms of q, k, v and p, BK 32; 16-bit -> q, k, v
    as they are and p in two terms of their dtype, BK 64."""
    f32 = dtype == torch.float32
    nt, npt, bk = (3, 3, 32) if f32 else (1, 2, 64)
    term = torch.bfloat16 if f32 else dtype
    small = _SMALL if f32 else ()
    pv_pairs = _SMALL + ((0, 0),) if f32 else ((1, 0), (0, 0))
    qs, ks, vs = (_terms(t.float(), nt, term) for t in (q, k, v))
    bh, s, d = q.shape
    scale = _LOG2E / head_dim ** 0.5
    out = torch.empty(bh, s, d)
    for q0 in range(0, s, 128):
        rows = torch.arange(q0, min(q0 + 128, s))
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        o = torch.zeros(bh, len(rows), d)
        kt_end = -(-s // bk)
        if causal:
            kt_end = min((q0 + 128 + bk - 1) // bk, kt_end)
        kt0 = (q0 - window) // bk if window and q0 - window > 0 else 0
        for kt in range(kt0, kt_end):
            cols = torch.arange(kt * bk, min(kt * bk + bk, s))
            prod = lambda a, b: qs[a][:, rows] @ ks[b][:, cols].transpose(1, 2)
            lo = sum((prod(a, b) for a, b in small), torch.zeros(()))
            x = (prod(0, 0) + lo) * scale
            keep = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                keep &= cols[None, :] <= rows[:, None]
            if window:
                keep &= cols[None, :] > rows[:, None] - window
            x = torch.where(keep, x, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            ps = _terms(p, npt, term)
            tile = sum(ps[a] @ vs[b][:, cols] for a, b in pv_pairs)
            o = o * corr[..., None] + tile
            m = m_new
        out[:, rows] = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(dtype)


@pytest.mark.parametrize("s,d,causal,window", [
    (128, 64, True, None),
    (256, 128, False, None),
    (256, 64, True, 32),
    (128, 48, True, None),
    (128, 128, False, 64),
])
def test_split_arithmetic_matches_reference_f32(s, d, causal, window):
    """The three-term bf16 split with its six kept products (padded D 48
    through its true-D scale) meets the reference's f32 tolerance."""
    arrays = _qkv(1000 + s + d, (1, 2, s, d))
    want = np.asarray(jops.flash_attention(
        *[jnp.asarray(a) for a in arrays], causal=causal, window=window,
        bq=64, bk=64), np.float32)
    dk = fa_kernel.kernel_head_dim(d, torch.float32)
    tin = [torch.nn.functional.pad(torch.from_numpy(a), (0, dk - d))
           .reshape(2, s, dk) for a in arrays]
    got = _split_flash(*tin, causal, window, d, torch.float32)
    got = got[..., :d].reshape(1, 2, s, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # one bf16 term alone (the wgmma kernel's rounding) would not
    one = [t.to(torch.bfloat16).float() for t in tin]
    coarse = fa_ref.sdpa(*[t[None] for t in one], causal=causal,
                         window=window, head_dim=d)[0][..., :d]
    assert np.abs(coarse.reshape(1, 2, s, d).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("dtype,causal,window", [
    (jnp.bfloat16, True, None), (jnp.float16, False, 64),
    (jnp.bfloat16, True, 64)])
def test_split_arithmetic_matches_reference_wide_16bit(dtype, causal,
                                                       window):
    """D = 320 in 16 bits: p in two terms of the input dtype keeps the
    output within one ulp of the reference's."""
    arrays = _qkv(320 + int(causal), (1, 2, 128, 320))
    jin = [jnp.asarray(a).astype(dtype) for a in arrays]
    want = np.asarray(jops.flash_attention(*jin, causal=causal,
                                           window=window, bq=64, bk=64),
                      np.float32)
    tdt = _TORCH_DTYPES[dtype]
    tin = [torch.from_numpy(a).to(tdt).reshape(2, 128, 320) for a in arrays]
    got = _split_flash(*tin, causal, window, 320, tdt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().reshape(1, 2, 128, 320).numpy(),
                               want, **WIDE_TOL[dtype])


def test_flash_bench_cases_and_needs_a_card(monkeypatch):
    """The timing script's case grammar; without a card it raises rather
    than time the CPU."""
    from repro_torch.benchmarks import flash_bench
    assert flash_bench.parse_case("bf16:2,8,1024,512") == (
        torch.bfloat16, (2, 8, 1024, 512))
    assert flash_bench.parse_case("f32:8,24,2048,128")[0] == torch.float32
    for bad in ("f64:1,1,8,8", "f32:1,8,8"):
        with pytest.raises(ValueError, match="not"):
            flash_bench.parse_case(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        flash_bench.run()
