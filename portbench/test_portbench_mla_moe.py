"""The MLA / dropless-MoE reference (``reference/mla_moe.py``) against the
program at a reduced width on the CPU, on the same weights and rows: the
loss and every leaf's gradient, as ``test_portbench_reference.py`` holds
the dense reference, and the FLOP count's parts."""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from portbench import data, weights  # noqa: E402
from portbench.reference import mla_moe as R  # noqa: E402

NAME = "moonlight-16b-a3b"


def small(dtype: str = "float32") -> dict:
    c = copy.deepcopy(json.loads((HERE / "configs" / f"{NAME}.json")
                                 .read_text()))
    c.update(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=500, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
             n_routed_experts=16, num_experts_per_tok=4, experts_held=2,
             expert_first=2, compute_dtype=dtype)
    return c


def port(c: dict):
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config(c["arch"]), n_layers=c["n_layers"],
        d_model=c["d_model"], n_heads=c["n_heads"],
        n_kv_heads=c["n_kv_heads"], d_ff=c["d_ff"], vocab=c["vocab"],
        rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
        compute_dtype=c["compute_dtype"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"],
        qk_rope_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        moe_d_ff=c["moe_intermediate_size"],
        n_experts=c["n_routed_experts"], moe_top_k=c["num_experts_per_tok"],
        experts_held=c["experts_held"], expert_first=c["expert_first"])


def test_the_layout_is_the_programs():
    from repro_torch.models.transformer import leaf_shapes
    c = small()
    assert [(lf.path, lf.shape) for lf in R.leaves(c)] == \
        leaf_shapes(port(c))
    full = json.loads((HERE / "configs" / f"{NAME}.json").read_text())
    assert R.n_params(full) == full["parameters"]
    with pytest.raises(ValueError):
        R.leaves(c, 2)


def test_loss_and_gradient_match_the_program():
    """Float32 on both sides, the same operations in other orders: the
    loss at 2e-5 and each leaf's gradient at 2e-5 of its norm (the dense
    reference's float32 tolerances)."""
    from repro_torch.models.transformer import Transformer, loss_fn
    tol = 2e-5
    c = small()
    flat = weights.global_params(c, 3, "cpu", 1, R)
    # the router's draw scaled up, so that the sigmoid scores spread
    params = R.unflatten(flat, c)
    params["blocks.l0.ffn.router"].mul_(25)
    b = {k: torch.from_numpy(v) for k, v in
         data.batch_at(c["vocab"], True, 4, 12, 5, 0).items()}
    loss, grads = R.loss_and_grads(params, b, c, rows=1)
    x = flat.clone()
    g = torch.zeros_like(x)
    model = Transformer(port(c), x)
    model.bind_grads(g)
    total, met = loss_fn(model, b, c["assumed"]["aux_weight"])
    total.backward()
    assert loss == pytest.approx(float(met["loss"].detach()), rel=tol)
    mine = R.shard_flat(grads, c, 1, 0, x.shape[0])
    off = 0
    for lf, n in zip(R.leaves(c), R.shard_sizes(c)):
        a, b_ = mine[off:off + n], g[off:off + n]
        assert torch.linalg.vector_norm(a - b_) <= \
            tol * torch.linalg.vector_norm(b_) + 1e-12, lf.path
        off += n


def _metric(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kernel", ["moe_permute", "moe_combine"])
def test_dispatch_costs_are_the_programs(kernel, backward):
    from repro_torch.perf import kernel_cost as K
    size = dict(t=16384, k=6, d=2048, itemsize=2, filled=12009,
                tokens=9158)
    want = getattr(K, f"{kernel}_cost")(backward=backward, **size)
    got = _metric(f"kernels.{kernel}_roofline").cost(backward, **size)
    assert got == (want.flops, want.hbm_bytes)


def test_step_flops_counts_the_held_experts_at_their_share():
    from portbench.flops import mla_moe as FL
    c = json.loads((HERE / "configs" / f"{NAME}.json").read_text())
    d = c["d_model"]
    mla = d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d
    moe = d * 64 + 3 * d * 1408 * 2 + 3 * d * 1408 * 6 * 8 / 64
    want = 9 * mla + 3 * d * 11264 + 8 * moe + d * 20480
    assert FL.matmul_params(c) == pytest.approx(want)
    assert FL.step_flops(c, 16384, 4096) == pytest.approx(
        6 * want * 16384 + 9 * 6 * 16 * 320 * 4096 * 16384)
