"""The port's 1-bit compression against the JAX reference.

Same numpy inputs to ``repro_torch`` (plain version on CPU tensors) and to
``repro.kernels.onebit.ref``, ``repro.kernels.onebit.ops`` (Pallas in
interpret mode) and ``repro.core.compression``.  The packed sign bits are
bitwise; the scales are a mean whose summation order differs between
torch and XLA, so they agree to rtol 1e-6 (the tolerance of
tests/test_kernels.py), and new_err, which is ``buf - scale``, to rtol
1e-5 / atol 1e-6 scaled by the input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.kernels.onebit import ops as jops  # noqa: E402
from repro.kernels.onebit import ref as jref  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.kernels.onebit import kernel as tkernel  # noqa: E402
from repro_torch.kernels.onebit import ops as tops  # noqa: E402
from repro_torch.kernels.onebit import ref as tref  # noqa: E402


def _data(seed, nblocks, block, scale=1.0, escale=0.1):
    rng = np.random.default_rng(seed)
    d = nblocks * block
    x = (rng.standard_normal(d) * scale).astype(np.float32)
    err = (rng.standard_normal(d) * escale).astype(np.float32)
    # exact zeros and negative zeros pack as +1, as in the reference
    x[:3] = [0.0, -0.0, 0.0]
    return x, err


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nblocks,block", [(4, 256), (3, 512), (2, 4096)])
def test_compress_matches_reference(seed, nblocks, block):
    x, _ = _data(seed, nblocks, block)
    packed, scales = tref.compress(_t(x), block)
    for jp, js in (jref.compress(jnp.asarray(x), block),
                   jops.compress(jnp.asarray(x), block),
                   jcomp.compress_onebit(jnp.asarray(x), block)):
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
        np.testing.assert_allclose(scales.numpy(), np.asarray(js),
                                   rtol=1e-6)
    # the port's public path takes the plain version for CPU tensors
    tp, ts = tcomp.compress_onebit(_t(x), block)
    np.testing.assert_array_equal(tp.numpy(), packed.numpy())
    np.testing.assert_array_equal(ts.numpy(), scales.numpy())


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("block", [256, 512])
def test_pack_and_decompress_bitwise(seed, block):
    x, _ = _data(seed, 4, block)
    np.testing.assert_array_equal(tcomp.pack_signs(_t(x)).numpy(),
                                  np.asarray(jcomp.pack_signs(jnp.asarray(x))))
    packed = np.asarray(jcomp.pack_signs(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tcomp.unpack_signs(_t(packed)).numpy(),
        np.asarray(jcomp.unpack_signs(jnp.asarray(packed))))
    scales = np.abs(x.reshape(-1, block)).mean(axis=1).astype(np.float32)
    want = np.asarray(jref.decompress(jnp.asarray(packed),
                                      jnp.asarray(scales), block))
    for got in (tref.decompress(_t(packed), _t(scales), block),
                tops.decompress(_t(packed), _t(scales), block),
                tcomp.decompress_onebit(_t(packed), _t(scales), block)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jops.decompress(jnp.asarray(packed),
                                         jnp.asarray(scales), block)))


@pytest.mark.parametrize("seed,escale", [(0, 0.1), (1, 1.0), (2, 10.0)])
def test_ef_compress_matches_reference(seed, escale):
    block = 512
    x, err = _data(seed, 3, block, escale=escale)
    pk, sc, ne = tops.ef_compress_fused(_t(x), _t(err), block)
    (cpk, csc), cne = tcomp.ef_compress(
        _t(x), _t(err), tcomp.CompressionConfig(block_size=block))
    np.testing.assert_array_equal(cpk.numpy(), pk.numpy())
    np.testing.assert_array_equal(cne.numpy(), ne.numpy())
    tol = 1e-6 * max(escale, 1.0)
    for jp, js, jn in (
            jops.ef_compress_fused(jnp.asarray(x), jnp.asarray(err), block),
            jref.ef_compress_fused(jnp.asarray(x), jnp.asarray(err), block)):
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jp))
        np.testing.assert_allclose(sc.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(ne.numpy(), np.asarray(jn), rtol=1e-5,
                                   atol=tol)
    (jp, js), jn = jcomp.ef_compress(jnp.asarray(x), jnp.asarray(err),
                                     jcomp.CompressionConfig(block_size=block))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ne.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=tol)


@pytest.mark.parametrize("seed", [0, 5])
def test_ef_identity(seed):
    """decompress(payload) + new_err == x + err (the EF invariant)."""
    block = 256
    x, err = _data(seed, 4, block, escale=1.0)
    pk, sc, ne = tops.ef_compress_fused(_t(x), _t(err), block)
    recon = tops.decompress(pk, sc, block) + ne
    np.testing.assert_allclose(recon.numpy(), x + err, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [4096, 8192 * 3, 364_564_480])
@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("kind", ["onebit", "identity"])
def test_wire_bytes_and_padding(d, block, kind):
    tc = tcomp.CompressionConfig(kind=kind, block_size=block)
    jc = jcomp.CompressionConfig(kind=kind, block_size=block)
    assert tcomp.wire_bytes(d, tc) == jcomp.wire_bytes(d, jc)
    for n in (1, 2, 4):
        assert tcomp.padded_length(d + 7, n, block) == \
            jcomp.padded_length(d + 7, n, block)


def test_identity_ef_compress_matches_reference():
    x, err = _data(0, 2, 256)
    cfg = tcomp.CompressionConfig(kind="identity", block_size=256)
    (buf, empty), ne = tcomp.ef_compress(_t(x), _t(err), cfg)
    (jbuf, jempty), jne = jcomp.ef_compress(
        jnp.asarray(x), jnp.asarray(err),
        jcomp.CompressionConfig(kind="identity", block_size=256))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert empty.shape == jempty.shape
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))


def test_devices_without_a_path_raise():
    """No quiet fallback: the kernel wrapper takes CUDA tensors only; a
    meta tensor (the dry run) gets empty meta outputs of the kernel's
    shapes and a recorded stand-in launch that leaves the launch counts
    alone, and is never computed on another device."""
    from repro_torch.kernels import build
    from repro_torch.perf import kernel_cost
    x = torch.zeros(512)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ef_compress_fused(x, x, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.decompress(torch.zeros(64, dtype=torch.uint8),
                           torch.zeros(2), 256)
    meta = torch.empty(512, device="meta")
    before = build.launch_counts()
    with build.recording() as rec:
        packed, scales, new_err = tops.ef_compress_fused(meta, meta, 256)
    assert build.launch_counts() == before
    assert rec == [("ef_compress", kernel_cost.ef_compress_cost(512, 256))]
    assert [(t.device.type, tuple(t.shape), t.dtype) for t in
            (packed, scales, new_err)] == [
        ("meta", (64,), torch.uint8), ("meta", (2,), torch.float32),
        ("meta", (512,), torch.float32)]
    with pytest.raises(ValueError, match="block_size"):
        tops.ef_compress_fused(meta, meta, 300)


@pytest.mark.parametrize("block", [8, 40, 520])
def test_kernel_rejects_blocks_off_the_warp(block):
    """Blocks that are not multiples of the 32-element warp are the
    reference's too: the CUDA wrapper's block checks take every multiple
    of 8 that divides d (a CPU tensor then stops at the device check), and
    refuse, before any launch, only what the reference refuses."""
    x = torch.zeros(block * 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.ef_compress_fused(x, x, block)
    with pytest.raises(ValueError, match="multiple of 8"):
        tkernel.ef_compress_fused(x, x, block + 4)
    y = torch.zeros(block * 4 + block // 2)
    with pytest.raises(ValueError, match="not a multiple"):
        tkernel.ef_compress_fused(y, y, block)
