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

The wrapper's contract is checked as well: ValueError where the
reference asserts (S not a multiple of the clamped blocks), the head dims
the CUDA kernels refuse (D > 256; a CPU tensor of any D takes the plain
version), and forward only.
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
    """D = 48: the CPU path computes it (the plain version takes any D),
    and the CUDA wrapper takes it too (zero-padded to 64), so a CPU tensor
    is refused only for its device; D = 300 is past every kernel's 256."""
    arrays = _qkv(7, (1, 2, 64, 48))
    got, want = _both(arrays, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    q = torch.from_numpy(arrays[0])
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fa_kernel.flash_attention(q.to(dtype), q.to(dtype), q.to(dtype))
    big = torch.zeros(1, 1, 8, 300)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dim 300"):
            fa_kernel.flash_attention(big.to(dtype), big.to(dtype),
                                      big.to(dtype))


@pytest.mark.parametrize("d,dtype,causal,window", [
    (48, None, True, None),
    (80, None, False, None),
    (48, jnp.float16, True, None),
    (80, jnp.float16, True, 64),
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
