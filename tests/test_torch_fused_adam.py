"""The port's fused Adam against the JAX reference.

Same numpy inputs to ``repro_torch.kernels.fused_adam`` (plain version on
CPU tensors) and to ``repro.kernels.fused_adam.ref`` and ``.ops`` (Pallas
in interpret mode), at the tolerance tests/test_kernels.py uses for the
kernel (rtol 1e-5 / atol 5e-7: FMA contraction and the order of the
square differ at the ULP).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_adam import ops as jops  # noqa: E402
from repro.kernels.fused_adam import ref as jref  # noqa: E402
from repro_torch.kernels.fused_adam import kernel as tkernel  # noqa: E402
from repro_torch.kernels.fused_adam import ops as tops  # noqa: E402
from repro_torch.kernels.fused_adam import ref as tref  # noqa: E402

B1, B2, EPS = 0.9, 0.999, 1e-8


def _data(seed, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32)
    m = (rng.standard_normal(d) * 0.01).astype(np.float32)
    v = np.abs(rng.standard_normal(d) * 1e-4).astype(np.float32)
    g = (rng.standard_normal(d) * 0.01).astype(np.float32)
    return x, m, v, g


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=5e-7)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d", [8192, 16384])
@pytest.mark.parametrize("lr", [1e-3, 0.1])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_matches_reference(seed, d, lr, wd):
    x, m, v, g = _data(seed, d)
    got = [t.numpy() for t in tops.adam_step(
        *(torch.from_numpy(a) for a in (x, m, v, g)), lr, B1, B2, EPS, wd)]
    jargs = [jnp.asarray(a) for a in (x, m, v, g)]
    _close(got, jref.adam_step(*jargs, jnp.float32(lr), B1, B2, EPS, wd))
    _close(got, jops.adam_step(*jargs, jnp.float32(lr), B1, B2, EPS, wd))


@pytest.mark.parametrize("seed", [0, 4])
def test_padding_path(seed):
    """d = 1000 is padded to the 8192 tile and cut back, as in the
    reference's ops wrapper."""
    x, m, v, g = _data(seed, 1000)
    got = tops.adam_step(*(torch.from_numpy(a) for a in (x, m, v, g)),
                         1e-3, B1, B2, EPS, 0.01)
    assert all(t.shape == (1000,) for t in got)
    want = jops.adam_step(*(jnp.asarray(a) for a in (x, m, v, g)),
                          jnp.float32(1e-3), B1, B2, EPS, 0.01)
    _close([t.numpy() for t in got], want)


def test_plain_is_the_kernel_order():
    """ops on CPU tensors is the plain version, bitwise."""
    x, m, v, g = (torch.from_numpy(a) for a in _data(2, 8192))
    for a, b in zip(tops.adam_step(x, m, v, g, 1e-3),
                    tref.adam_step(x, m, v, g, 1e-3, B1, B2, EPS)):
        assert torch.equal(a, b)


def test_devices_without_a_path_raise():
    x = torch.zeros(8192)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.adam_step(x, x, x, x, 1e-3)
    # a meta tensor (the dry run): empty meta outputs and a recorded
    # stand-in launch that leaves the launch counts alone
    from repro_torch.kernels import build
    from repro_torch.perf import kernel_cost
    meta = torch.empty(8192, device="meta")
    before = build.launch_counts()
    with build.recording() as rec:
        out = tops.adam_step(meta, meta, meta, meta, 1e-3)
    assert build.launch_counts() == before
    assert rec == [("adam_step",
                    kernel_cost.adam_update_cost(8192, fused=True))]
    assert [(t.device.type, tuple(t.shape)) for t in out] == \
        [("meta", (8192,))] * 3
