"""The port's flash-attention op against the JAX package's.

The same numpy inputs, made from a seed, go through the reference's
``repro.kernels.flash_attn.ops.flash_attention`` (the Pallas kernel in
interpret mode on the CPU) and the port's ``ops.flash_attention`` (on the
CPU: its plain version, ``ref.sdpa``), over the grid of S, D, causal,
window and blocks of ``tests/test_kernels.py``.  Tolerances are that
file's: f32 rtol 1e-5 / atol 2e-6 (the kernel's online softmax sums in
another order than one softmax), bf16 rtol 2e-2 / atol 2e-2 (one bf16
rounding of the output, on either side of a near-tie).

The wrapper's contract is checked as well: ValueError where the
reference asserts (S not a multiple of the clamped blocks), the head dims
the CUDA kernel refuses (only a CUDA tensor reaches the kernel; a CPU
tensor of any D takes the plain version), and forward only.
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


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype=None, **kw):
    jin = [jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)
           for a in arrays]
    want = np.asarray(jops.flash_attention(*jin, **kw), np.float32)
    tin = [torch.from_numpy(a) if dtype is None
           else torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    got = fa_ops.flash_attention(*tin, **kw)
    return got, want


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
    """D = 48: the CPU path computes it (the plain version takes any D);
    the CUDA kernel's wrapper refuses it before it looks at the device."""
    arrays = _qkv(7, (1, 2, 64, 48))
    got, want = _both(arrays, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    q = torch.from_numpy(arrays[0])
    with pytest.raises(ValueError, match="head dim 48"):
        fa_kernel.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention(q[..., :32].contiguous(),
                                  q[..., :32].contiguous(),
                                  q[..., :32].contiguous())


def test_forward_only_and_cpu_counts_no_launch():
    q = torch.randn(1, 1, 64, 32, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        fa_ops.flash_attention(q, q, q)
    before = build.launch_counts()["flash_attention"]
    with torch.no_grad():
        out = fa_ops.flash_attention(q, q, q)
    torch.testing.assert_close(out, fa_ref.sdpa(q.detach(), q.detach(),
                                                q.detach()))
    assert build.launch_counts()["flash_attention"] == before
