"""The port's DeepSeek-V3 archs (``moonlight-16b-a3b`` and its EP-8 share)
against the plain reference ``portbench/reference/mla_moe.py`` in float32
at the ``-smoke`` sizes on the CPU: MLA, the dropless expert layer with a
non-zero selection bias, the expert-parallel shares against the whole
layer, the dispatch kernels' plain versions, the model's loss and flat
gradient through ``train_step``, a ``launch.train.run`` through the
switch, the tp and serving refusals, and the spans and counters.

Tolerances: both sides compute in float32 with the same operations but
in other orders (concatenated vs summed score parts, choice-order vs
expert-order sums, grouped vs per-expert products), so each gap is a few
float32 roundings of the largest value compared: outputs at rtol 1e-5 /
atol 1e-5 of values of order 1, gradients at 1e-4 of the largest entry
of each leaf (a sum over up to a few hundred rows).
"""
import dataclasses

import pytest
import torch

from portbench.reference import mla_moe as R
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import flat_from_params
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.kernels.moe_dispatch import ref as DR
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import transformer as T
from repro_torch.obs import trace

SMOKE = "moonlight-16b-a3b-smoke"
EP8 = "moonlight-16b-a3b-ep8-smoke"
GRAD_SHARE = 1e-4


def published(cfg) -> dict:
    """A port config under the published keys the reference reads."""
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_dim,
                qk_rope_head_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                d_ff=cfg.d_ff, n_routed_experts=cfg.n_experts,
                num_experts_per_tok=cfg.moe_top_k,
                moe_intermediate_size=cfg.moe_ff,
                n_shared_experts=cfg.n_shared_experts,
                routed_scaling_factor=cfg.moe_gate_scale,
                experts_held=cfg.n_held, expert_first=cfg.expert_first,
                first_k_dense_replace=cfg.n_dense_lead,
                n_layers=cfg.n_layers, vocab=cfg.vocab,
                compute_dtype=cfg.compute_dtype)


def dims(cfg) -> dict:
    """The reference's sizes of a port config."""
    return R.dims(published(cfg))


def layer(cfg, part: str, seed: int = 0, i: int = 0) -> dict:
    """Layer ``i``'s ``mixer`` or ``ffn`` leaves of the MoE stack, each a
    leaf that requires grad; the router's draw scaled up so that the
    sigmoid scores spread."""
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    pre = f"blocks.l0.{part}."
    out = {k[len(pre):]: v[i].clone() for k, v in params.items()
           if k.startswith(pre)}
    if "router" in out:
        out["router"] = out["router"] * 50
    return {k: v.requires_grad_(True) for k, v in out.items()}


def close_grads(a: dict, b: dict) -> None:
    for k in b:
        ga, gb = a[k].grad, b[k].grad
        assert (ga - gb).abs().max() <= GRAD_SHARE * gb.abs().max() + 1e-12, k


def twin(p: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl,s", [("full", 24), ("chunked", 128)])
def test_mla_matches_reference(impl, s):
    cfg = dataclasses.replace(get_config(SMOKE), attn_impl=impl)
    assert cfg.qk_nope_dim + cfg.qk_rope_dim != cfg.v_head_dim
    p = layer(cfg, "mixer")
    q = twin(p)
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    y = A.mla_forward(p, x, cfg)
    want = R.mla(q, x2, dims(cfg), torch.float32)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    ct = torch.randn_like(y)
    (y * ct).sum().backward()
    (want * ct).sum().backward()
    close_grads(p, q)
    assert (x.grad - x2.grad).abs().max() <= \
        GRAD_SHARE * x2.grad.abs().max()


@pytest.mark.parametrize("arch", [SMOKE, EP8])
def test_expert_layer_matches_reference_with_a_selection_bias(arch):
    cfg = get_config(arch)
    p = layer(cfg, "ffn")
    q = twin(p)
    gen = torch.Generator().manual_seed(2)
    bias = torch.randn(cfg.n_experts, generator=gen) * 0.3
    x = torch.randn(2, 32, cfg.d_model, generator=gen, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    y, aux = M.dropless_moe_forward(p, x, cfg, bias)
    want, aux_b = R.experts(q, x2, dims(cfg), torch.float32, bias)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, aux_b.mean(), rtol=1e-6, atol=0)
    # the bias moves the choice: the same layer without it routes otherwise
    rt0 = M.route(x.detach().reshape(-1, cfg.d_model), p["router"],
                  torch.zeros_like(bias), cfg)
    rt1 = M.route(x.detach().reshape(-1, cfg.d_model), p["router"], bias, cfg)
    assert not torch.equal(rt0.chosen, rt1.chosen)
    ct = torch.randn_like(y)
    ((y * ct).sum() + aux).backward()
    ((want * ct).sum() + aux_b.mean()).backward()
    close_grads(p, q)
    assert (x.grad - x2.grad).abs().max() <= \
        GRAD_SHARE * x2.grad.abs().max()


def test_ep_shares_add_up_to_the_whole_layer():
    """Eight chips of 2 experts each: their parts, the shared experts
    counted once, are the uncut layer's output, the reference's whole
    layer too."""
    cfg = get_config(SMOKE)
    assert cfg.n_held == cfg.n_experts == 16
    p = {k: v.detach() for k, v in layer(cfg, "ffn", seed=3).items()}
    bias = torch.zeros(cfg.n_experts)
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    whole, _ = M.dropless_moe_forward(p, x, cfg, bias)
    parts = []
    for r in range(8):
        share = dataclasses.replace(cfg, experts_held=2, expert_first=2 * r)
        sp = {k: v[2 * r:2 * r + 2] if k in ("wg", "wu", "wd") else v
              for k, v in p.items() if r == 0 or not k.startswith("shared")}
        parts.append(M.dropless_moe_forward(sp, x, share, bias)[0])
    torch.testing.assert_close(sum(parts), whole, rtol=1e-5, atol=1e-5)
    want, _ = R.experts(p, x, dims(cfg), torch.float32, bias)
    torch.testing.assert_close(sum(parts), want, rtol=1e-5, atol=1e-5)


def test_route_orders_rows_by_expert_then_token():
    cfg = get_config(EP8)
    p = layer(cfg, "ffn", seed=5)
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    rt = M.route(x, p["router"].detach(), torch.zeros(cfg.n_experts), cfg)
    k = cfg.moe_top_k
    local = rt.chosen - cfg.expert_first
    held = (local >= 0) & (local < cfg.n_held)
    n = int(held.sum())
    assert int(rt.offs[-1]) == n == int(rt.counts.sum()) > 0
    assert torch.equal(rt.slot >= 0, held)
    rows = rt.slot[held].long()
    assert sorted(rows.tolist()) == list(range(n))
    assert (rt.pair[n:] == -1).all()
    assert torch.equal(rt.pair[rows], (torch.arange(64 * k).view(64, k)
                                       [held]).to(torch.int32))
    # row order: expert-major, token order within an expert
    e_of = local.reshape(-1)[rt.pair[:n].long()]
    t_of = rt.pair[:n].long() // k
    assert torch.equal(e_of, e_of.sort().values)
    for e in range(cfg.n_held):
        ts = t_of[e_of == e]
        assert torch.equal(ts, ts.sort().values)


def test_route_breaks_saturated_ties_by_the_logit():
    """Logits above ~16.6 round s to 1.0 in float32: the choice follows the
    logits' order, not the lowest expert indices."""
    cfg = get_config(EP8)
    e, k = cfg.n_experts, cfg.moe_top_k
    gen = torch.Generator().manual_seed(9)
    logits = 20.0 + torch.rand(32, e, generator=gen) * 10
    assert (torch.sigmoid(logits) == 1.0).all()
    x, router = logits, torch.eye(e)     # x @ router == logits, d == E
    c = dataclasses.replace(cfg, d_model=e)
    rt = M.route(x, router, torch.zeros(e), c)
    assert torch.equal(rt.chosen, torch.topk(logits, k, dim=-1).indices)
    assert not torch.equal(rt.chosen[:, :k].sort(dim=-1).values,
                           torch.arange(k).expand(32, k))
    assert torch.equal(M.choose(torch.ones(32, e), logits, k), rt.chosen)


def test_dispatch_plain_versions_match_index_gathers():
    cfg = get_config(EP8)
    k, t, d = cfg.moe_top_k, 48, 32
    gen = torch.Generator().manual_seed(7)
    p = layer(cfg, "ffn", seed=8)
    x = torch.randn(t, cfg.d_model, generator=gen)
    rt = M.route(x, p["router"].detach(), torch.zeros(cfg.n_experts), cfg)
    xs = torch.randn(t, d, generator=gen)
    xp = DR.permute(xs, rt.pair, k)
    live = rt.pair >= 0
    assert torch.equal(xp[live], xs[rt.pair[live].long() // k])
    assert not xp[~live].any()
    dxp = torch.randn(t * k, d, generator=gen)
    want = torch.zeros(t, d)
    for tok in range(t):
        for j in range(k):
            if rt.slot[tok, j] >= 0:
                want[tok] += dxp[rt.slot[tok, j]]
    torch.testing.assert_close(DR.permute_backward(dxp, rt.slot), want,
                               rtol=0, atol=1e-6)
    ye = torch.randn(t * k, d, generator=gen, requires_grad=True)
    g = rt.gates.detach().clone().requires_grad_(True)
    y = DR.combine(ye.detach(), g.detach(), rt.slot)
    ref = torch.zeros(t, d)
    for tok in range(t):
        for j in range(k):
            if rt.slot[tok, j] >= 0:
                ref = ref.index_add(0, torch.tensor([tok]),
                                    g[tok, j] * ye[rt.slot[tok, j]][None])
    torch.testing.assert_close(y, ref.detach(), rtol=0, atol=1e-6)
    dy = torch.randn(t, d, generator=gen)
    (ref * dy).sum().backward()
    dye, dg = DR.combine_backward(dy, ye.detach(), g.detach(), rt.pair, k)
    torch.testing.assert_close(dye[live], ye.grad[live], rtol=0, atol=1e-6)
    assert not dye[~live].any()
    torch.testing.assert_close(dg, g.grad, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the model through the training path
# --------------------------------------------------------------------------

def test_loss_and_flat_gradient_through_train_step():
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import init_train_state, train_step
    cfg = get_config(EP8)
    params = T.init_params(cfg, torch.Generator().manual_seed(9))
    params = {k: v * 50 if k.endswith("router") else v
              for k, v in params.items()}
    batch = SyntheticStream(cfg, InputShape("t", 32, 2, "train"),
                            seed=0).batch_at(0)
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": 512})
    ts = init_train_state(cfg, params, opt, 512)
    gen = torch.Generator().manual_seed(10)
    biases = [torch.randn(cfg.n_experts, generator=gen) * 0.3
              for _ in range(cfg.n_layers - cfg.n_dense_lead)]
    moe_blocks = [b for b in ts.model.blocks if b.ffn_kind == "dropless"]
    for blk, bias in zip(moe_blocks, biases):
        blk.e_bias.copy_(bias)
    x0 = ts.x.clone()
    met = train_step(ts, opt, batch, 1e-3, "warmup")
    ref = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    assert cfg.compute_dtype == "float32"
    nll, aux = R.nll_sum(ref, batch, published(cfg), biases)
    lm = nll / batch["labels"].numel()
    total = lm + 0.01 * aux / batch["labels"].shape[0]      # aux_weight
    total.backward()
    assert float(met["loss"]) == pytest.approx(lm.item(), rel=1e-5)
    assert float(met["total"]) == pytest.approx(total.item(), rel=1e-5)
    assert float(aux) > 0
    want = flat_from_params({k: v.grad for k, v in ref.items()},
                            ts.x.shape[0])
    off = 0
    for path, shape in T.leaf_shapes(cfg):
        n = torch.Size(shape).numel()
        a, b = ts.g[off:off + n], want[off:off + n]
        assert (a - b).abs().max() <= GRAD_SHARE * b.abs().max() + 1e-12, \
            path
        off += n
    assert not torch.equal(ts.x, x0)


def test_run_trains_through_the_switch():
    from repro_torch.launch.train import run
    res = run(arch=SMOKE, device="cpu", steps=5, warmup_steps=3, batch=2,
              seq=32, block_size=512, verbose=False)
    hist = res["history"]
    assert [h["stage"] for h in hist] == ["warmup"] * 3 + ["compressed"] * 2
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_sizes_and_the_smoke_mechanism():
    full, ep8 = get_config("moonlight-16b-a3b"), \
        get_config("moonlight-16b-a3b-ep8")
    assert full.param_count() == 15_960_108_544
    cut = dataclasses.replace(ep8, n_layers=9, vocab=20480)
    assert cut.param_count() == 970_107_392
    assert (ep8.n_held, ep8.expert_first) == (8, 0)
    for cfg in (get_config(SMOKE), get_config(EP8)):
        assert cfg.n_dense_lead == 1 and cfg.n_layers - 1 >= 2
        assert cfg.is_mla and cfg.moe_kind == "dropless"
        assert cfg.qk_nope_dim + cfg.qk_rope_dim != cfg.v_head_dim
        assert [cfg.is_moe_layer(i) for i in range(cfg.n_layers)] == \
            [False] + [True] * (cfg.n_layers - 1)
    assert get_config(EP8).n_held < get_config(EP8).n_experts


@pytest.mark.parametrize("arch", [SMOKE, "moonlight-16b-a3b-ep8"])
def test_tp_and_serving_refuse_mla(arch):
    cfg = get_config(arch)
    with pytest.raises(ValueError, match=cfg.name):
        T.global_leaf_shapes(cfg, 2)
    with pytest.raises(ValueError, match="latent"):
        T.check_serving(cfg)
    with pytest.raises(ValueError, match="latent"):
        T.prefill({}, {"tokens": torch.zeros(1, 4, dtype=torch.int32)}, cfg)


def test_spans_and_counters(tmp_path, monkeypatch):
    import json
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(EP8)
    params = T.init_params(cfg, torch.Generator().manual_seed(11))
    flat = flat_from_params(params)
    model = T.Transformer(cfg, flat)
    model.bind_grads(torch.zeros_like(flat))
    batch = SyntheticStream(cfg, InputShape("t", 16, 2, "train"),
                            seed=0).batch_at(0)
    seen, real = [], M.route

    def spy(*a, **k):
        rt = real(*a, **k)
        seen.append((int(rt.offs[-1]), int(rt.counts.max())))
        return rt
    monkeypatch.setattr(M, "route", spy)
    trace.reset_counters()
    T.loss_fn(model, batch)[0].backward()
    assert trace.counters() == {}
    seen.clear()
    with trace.tracing(True), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        total, _ = T.loss_fn(model, batch)
        total.backward()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {trace.MLA_SPAN, trace.MOE_SPAN, trace.DISPATCH_SPAN} <= names
    # each layer routes again in its recompute (in reverse), which counts
    # nothing
    n_moe = cfg.n_layers - cfg.n_dense_lead
    assert len(seen) == 2 * n_moe and seen[n_moe:] == seen[:n_moe][::-1]
    got = trace.counters()["moe"]
    trace.reset_counters()
    assert got == {"rows": float(sum(r for r, _ in seen[:n_moe])),
                   "max_rows": float(max(m for _, m in seen[:n_moe]))}
    assert got["rows"] > 0
    assert trace.counters() == {}
