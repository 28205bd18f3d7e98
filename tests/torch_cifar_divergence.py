"""1-bit Adam at the paper's CIFAR shape in the JAX package and in the port,
on the CPU, from the same initial weights and batches.

The shape is ``chip_smoke.py`` phase 17c's: ResNet-18's stage widths (64,
128, 256, 512) at 32 x 32, batch 128, block 256, T_w 40 (the reference's
net keeps one block a stage).  The reference's
``benchmarks.resnet_convergence._train("onebit")`` runs with its init,
stream and loss bound to that shape (attributes of the imported module
are rebound; its file is not edited); the port's
``resnet_convergence.train("onebit")`` takes the reference's initial
weights and batches.  Both stop after ``STEPS`` steps.  Prints, as one
JSON line, both loss curves, the first non-finite step of each, and at the
first compressed update how many coordinates of the unpadded d have
v == 0 on each side (weights whose gradient was 0 through the whole
warmup: the compressed update moves them by lr * m_bar / eps).

  PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/torch_cifar_divergence.py
"""
import json
import math
import types

import jax
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

import benchmarks.resnet_convergence as JB
from repro.models import resnet as JR
from repro_torch.benchmarks import resnet_convergence as TB
from repro_torch.convert import params_from_jax

WIDTHS, SIZE, BATCH = (64, 128, 256, 512), 32, 128
STEPS = 45


def _stream(t):
    return JR.synthetic_cifar(jax.random.fold_in(jax.random.PRNGKey(0), t),
                              BATCH, size=SIZE)


def _reference(v_at_switch):
    """The reference's curve; ``v_at_switch`` receives v as the first
    compressed update is called (outside its jit, so concrete)."""
    real_jit = jax.jit

    def jit(f):
        jf = real_jit(f)
        if getattr(f, "__name__", "") != "upd_c":
            return jf

        def call(x, st, g):
            if not v_at_switch:
                v_at_switch.append(np.asarray(st.v))
            return jf(x, st, g)
        return call
    JB.jax = types.SimpleNamespace(
        **{k: getattr(jax, k) for k in ("random", "value_and_grad")},
        jit=jit)
    JB.init_resnet = lambda key: JR.init_resnet(key, WIDTHS)
    JB.resnet_loss = lambda p, b: JR.resnet_loss(p, b, WIDTHS)
    JB._stream = _stream
    return JB._train("onebit", steps=STEPS)


def _port(params, v_at_switch):
    """The port's curve from the reference's weights and batches."""
    real = TB.OB

    def compressed_update(g, st, *args):
        if not v_at_switch:
            v_at_switch.append(st.v.numpy().copy())
        return real.compressed_update(g, st, *args)
    TB.OB = types.SimpleNamespace(init=real.init,
                                  warmup_update=real.warmup_update,
                                  OneBitAdamConfig=real.OneBitAdamConfig,
                                  compressed_update=compressed_update)

    def batch(t):
        b = _stream(t)
        return {"images": torch.from_numpy(np.array(b["images"])),
                "labels": torch.from_numpy(np.array(b["labels"], np.int64))}
    try:
        return TB.train("onebit", STEPS, widths=WIDTHS, size=SIZE,
                        batch=BATCH, params=params, batches=batch)
    finally:
        TB.OB = real


def main():
    jp = JR.init_resnet(jax.random.PRNGKey(1), WIDTHS)
    d = ravel_pytree(jp)[0].shape[0]
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    jv, tv = [], []
    curves = {"reference": _reference(jv), "port": _port(params, tv)}
    out = {"shape": dict(widths=WIDTHS, size=SIZE, batch=BATCH,
                         block=TB.BLOCK, warmup=TB.WARMUP, d=d),
           "first_nonfinite": {k: next((t for t, x in enumerate(c)
                                        if not math.isfinite(x)), None)
                               for k, c in curves.items()},
           "v_zero_at_switch": {"reference": int((jv[0][:d] == 0).sum()),
                                "port": int((tv[0][:d] == 0).sum())},
           "curves": curves}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
