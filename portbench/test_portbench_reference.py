"""The plain reference against the program at a reduced width on the CPU,
on the same weights and rows: the model's loss and gradient, and 1-bit
Adam's two stages."""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from portbench import data, weights  # noqa: E402
from portbench.reference import onebit_adam as RA  # noqa: E402
from portbench.reference import transformer as R  # noqa: E402


def small(name: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(json.loads((HERE / "configs" / f"{name}.json")
                                 .read_text()))
    c.update(n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2 if c["causal"] else 4, d_ff=128, vocab=500,
             compute_dtype=dtype)
    return c


def port(c: dict):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(c["arch"]), **{
        k: c[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                          "d_ff", "vocab", "causal", "mlp_kind",
                          "rope_theta", "norm_eps", "compute_dtype")})


def batch(c: dict, seed: int = 5) -> dict:
    return {k: torch.from_numpy(v) for k, v in
            data.batch_at(c["vocab"], c["causal"], 4, 12, seed, 0).items()}


@pytest.mark.parametrize("name", ["bert-large", "internlm2-1.8b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_model_loss_and_gradient_match_the_program(name, dtype, tol):
    from repro_torch.models.transformer import Transformer, loss_fn
    c = small(name, dtype)
    flat = weights.global_params(c, 3, "cpu")
    b = batch(c)
    loss, grads = R.loss_and_grads(R.unflatten(flat, c), b, c, rows=3)
    x = flat.clone()
    g = torch.zeros_like(x)
    model = Transformer(port(c), x)
    model.bind_grads(g)
    total, _ = loss_fn(model, b)
    total.backward()
    assert loss == pytest.approx(float(total.detach()), rel=tol)
    mine = R.shard_flat(grads, c, 1, 0, x.shape[0])
    for lf, n, off in zip(R.leaves(c), R.shard_sizes(c),
                          [0] + list(torch.tensor(R.shard_sizes(c))
                                     .cumsum(0).tolist())):
        a, b_ = mine[off:off + n], g[off:off + n]
        assert torch.linalg.vector_norm(a - b_) <= \
            tol * torch.linalg.vector_norm(b_) + 1e-12, lf.path


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_join_back(tp):
    c = small("internlm2-1.8b")
    c.update(n_heads=4, n_kv_heads=4)
    params = R.unflatten(weights.global_params(c, 1, "cpu", tp), c, tp)
    n = sum(R.shard_sizes(c, tp))
    flats = [R.shard_flat(params, c, tp, r, n + 8) for r in range(tp)]
    joined = R.join_shards(flats, c, tp)
    assert all(torch.equal(joined[k], params[k]) for k in params)


@pytest.mark.parametrize("stage", ["warmup", "compressed"])
def test_onebit_adam_matches_the_program(stage):
    from repro_torch.optim import get_optimizer
    d, block = 8 * 512, 512
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(d, generator=gen)
    gs = [torch.randn(d, generator=gen) * 1e-2 for _ in range(3)]
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": block})
    st = opt.init_state(d, 1, 1)
    ref = RA.OneBitAdam(x, block=block)
    px = x.clone()
    for i, g in enumerate(gs):
        lr = 1e-3 * (i + 1)
        if stage == "warmup" or i == 0:
            px, st, _ = opt.warmup_update(g, st, px, lr)
            ref.warmup_step(g, lr)
        else:
            px, st, _ = opt.update(g, st, lr, x=px)
            ref.compressed_step(g, lr)
    for a, b in ((ref.x, px), (ref.m, st.m), (ref.v, st.v),
                 (ref.worker_err, st.worker_err),
                 (ref.server_err, st.server_err)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
