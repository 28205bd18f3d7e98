"""Plain PyTorch reference of the DeepSeek-V3 block that ``moonlight-16b-a3b``
runs (arXiv:2412.19437; the Moonlight config): multi-head latent attention
(MLA), ``first_k_dense_replace`` leading dense SwiGLU layers, then layers of
the sigmoid-routed, dropless expert layer with shared experts, the LM head
and the next-token loss with the sequence-wise balance term.

The one plain version of these equations, written from the paper and
the config, not from the program: the benchmark holds the program to it
through the harness's interface (``leaves``, ``shard_sizes``,
``shard_shape``, ``shard_flat``, ``join_shards``, ``unflatten``,
``n_params``, ``loss_and_grads``) at tp 1, and the port's CPU tests
(``tests/test_torch_moonlight.py``) through ``dims``, ``mla``,
``experts`` and ``nll_sum`` in float32.  The products are in the
configuration's ``compute_dtype`` with float32 weights rounded to it, as
``reference/transformer.py`` computes them: scores, softmax, the router
and the loss in float32.  It reads the configuration file's published
keys (``hidden_size``, ``kv_lora_rank``, ``qk_nope_head_dim``,
``qk_rope_head_dim``, ``v_head_dim``, ``n_routed_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``, ``n_shared_experts``,
``routed_scaling_factor``, ``first_k_dense_replace``, ...) and the cut's
(``n_layers``, ``vocab``, ``experts_held``, ``expert_first``): the chip
holds experts ``expert_first .. expert_first + experts_held - 1`` and
computes their part of each expert layer, the router keeping all
``n_routed_experts`` outputs and its top k.  Where the program differs in
method it differs here on purpose: the scores are the sum of the nope
and the rope products (the program concatenates the two parts), each
held expert gathers its own tokens and adds its gated output back with
``index_add`` (the program permutes rows and combines them in choice
order), and the balance term counts each sequence's routed experts
directly.

MLA: q = x wq ((nope + rope) dims a head), [c_kv, k_pe] = x wkva, c_kv
through an RMSNorm, [k_nope, v] = c_kv wkvb; the scores are the nope
product plus the rope product (k_pe one head shared by all), over
sqrt(nope + rope), causal.  The expert layer: s = sigmoid(x router) in
float32, the top k of s + b chosen, ties by the larger logit (b, the
selection bias: zero in the benchmark, where its update speed is 0; the
tests give it values), the gates the chosen s over their sum times
``routed_scaling_factor``; each held expert's SwiGLU on its own tokens,
added back gated (``index_add``), plus the shared experts' SwiGLU of
``n_shared_experts * moe_intermediate_size`` on every token.  The balance
term of a sequence is sum_e f_e P_e, f_e = E / (k S) times its tokens
routed to e, P_e the mean of s_e / sum_j s_j; the loss adds its mean over
the sequences, summed over the layers, times ``assumed.aux_weight``.

Departures from the published model, shared with the program: rope in
the half-split convention (the published interleaved layout equals it up
to a fixed permutation of the rope columns of wq and wkva), and the
chosen experts stand for the paper's top k of s in the balance term,
which they are while b is zero.

Nothing here imports the program: plain torch, with no kernel, cache or
batching of its own.  Gradients are taken by autograd over row blocks of
the batch, summed in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]      # the global shape
    split: Optional[int]        # the dim split over the model axis
    init: str                   # "ones" | "embed" | "fan_in"


def dims(cfg: dict) -> dict:
    """The sizes ``mla`` and ``experts`` read, from the configuration's
    published keys and the cut's."""
    return dict(d=cfg["d_model"], heads=cfg["n_heads"],
                rank=cfg["kv_lora_rank"], nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], vdim=cfg["v_head_dim"],
                theta=float(cfg["rope_theta"]), eps=cfg["norm_eps"],
                ff=cfg["d_ff"], experts=cfg["n_routed_experts"],
                top_k=cfg["num_experts_per_tok"],
                moe_ff=cfg["moe_intermediate_size"],
                shared=cfg["n_shared_experts"],
                scale=cfg["routed_scaling_factor"],
                held=cfg["experts_held"], first=cfg.get("expert_first", 0),
                lead=cfg["first_k_dense_replace"], layers=cfg["n_layers"],
                vocab=cfg["vocab"])


def padded_vocab(cfg: dict, tp: int = 1) -> int:
    q = 8 * tp
    return (cfg["vocab"] + q - 1) // q * q


def leaves(cfg: dict, tp: int = 1) -> List[Leaf]:
    """Every leaf in flat order (the program's: sorted dotted paths, the
    leading dense layers under ``blocks.first``), with its init law."""
    if tp != 1:
        raise ValueError("MLA and the dropless expert layer run at tp 1")
    c = dims(cfg)
    d, h, r = c["d"], c["heads"], c["rank"]
    nope, rp, vd = c["nope"], c["rope"], c["vdim"]

    def mla_leaves(pre, n):
        return [Leaf(pre + "mixer.norm_kv", (n, r), None, "ones"),
                Leaf(pre + "mixer.wkva", (n, d, r + rp), None, "fan_in"),
                Leaf(pre + "mixer.wkvb", (n, r, h * (nope + vd)), None,
                     "fan_in"),
                Leaf(pre + "mixer.wo", (n, h * vd, d), None, "fan_in"),
                Leaf(pre + "mixer.wq", (n, d, h * (nope + rp)), None,
                     "fan_in"),
                Leaf(pre + "norm1", (n, d), None, "ones"),
                Leaf(pre + "norm2", (n, d), None, "ones")]
    out = []
    lead, n_moe = c["lead"], c["layers"] - c["lead"]
    if lead:
        ff = c["ff"]
        out += [Leaf("blocks.first.ffn.wd", (lead, ff, d), None, "fan_in"),
                Leaf("blocks.first.ffn.wg", (lead, d, ff), None, "fan_in"),
                Leaf("blocks.first.ffn.wu", (lead, d, ff), None, "fan_in")]
        out += mla_leaves("blocks.first.", lead)
    e, f, fs = c["held"], c["moe_ff"], c["shared"] * c["moe_ff"]
    out += [Leaf("blocks.l0.ffn.router", (n_moe, d, c["experts"]), None,
                 "embed")]
    if fs:
        out += [Leaf("blocks.l0.ffn.shared_wd", (n_moe, fs, d), None,
                     "fan_in"),
                Leaf("blocks.l0.ffn.shared_wg", (n_moe, d, fs), None,
                     "fan_in"),
                Leaf("blocks.l0.ffn.shared_wu", (n_moe, d, fs), None,
                     "fan_in")]
    out += [Leaf("blocks.l0.ffn.wd", (n_moe, e, f, d), None, "fan_in"),
            Leaf("blocks.l0.ffn.wg", (n_moe, e, d, f), None, "fan_in"),
            Leaf("blocks.l0.ffn.wu", (n_moe, e, d, f), None, "fan_in")]
    out += mla_leaves("blocks.l0.", n_moe)
    vp = padded_vocab(cfg)
    out += [Leaf("embed", (vp, d), None, "embed"),
            Leaf("norm_f", (d,), None, "ones"),
            Leaf("w_out", (d, vp), None, "fan_in")]
    return out


def shard_shape(leaf: Leaf, tp: int) -> Tuple[int, ...]:
    return leaf.shape


def n_params(cfg: dict, tp: int = 1) -> int:
    return sum(math.prod(lf.shape) for lf in leaves(cfg, tp))


def shard_sizes(cfg: dict, tp: int = 1) -> List[int]:
    return [math.prod(lf.shape) for lf in leaves(cfg, tp)]


def unflatten(flat: torch.Tensor, cfg: dict, tp: int = 1
              ) -> Dict[str, torch.Tensor]:
    """Views of a flat vector of the leaves as the leaves."""
    out, off = {}, 0
    for lf in leaves(cfg, tp):
        n = math.prod(lf.shape)
        out[lf.path] = flat[off:off + n].view(lf.shape)
        off += n
    return out


def shard_flat(params: Dict[str, torch.Tensor], cfg: dict, tp: int,
               rank: int, d_pad: int) -> torch.Tensor:
    """The flat float32 vector of ``params``, zero-padded to ``d_pad``."""
    flat = torch.cat([params[lf.path].reshape(-1).to(torch.float32)
                      for lf in leaves(cfg, tp)])
    return F.pad(flat, (0, d_pad - flat.shape[0]))


def join_shards(flats: List[torch.Tensor], cfg: dict, tp: int
                ) -> Dict[str, torch.Tensor]:
    return unflatten(flats[0][:n_params(cfg, tp)], cfg, tp)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by its position along S (half-split)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos],
                     dim=-1).to(x.dtype)


def mla(p: Dict[str, torch.Tensor], x: torch.Tensor, c: dict, dt
        ) -> torch.Tensor:
    """One MLA layer (its leaves unstacked) on x (B, S, d), causal."""
    b, s, _ = x.shape
    h, r, nope, rp, vd = c["heads"], c["rank"], c["nope"], c["rope"], \
        c["vdim"]
    q = (x @ p["wq"].to(dt)).view(b, s, h, nope + rp)
    kva = x @ p["wkva"].to(dt)
    kv = (_rms(kva[..., :r], p["norm_kv"], c["eps"]) @ p["wkvb"].to(dt)) \
        .view(b, s, h, nope + vd)
    q_pe = _rope(q[..., nope:], c["theta"])
    k_pe = _rope(kva[..., r:].reshape(b, s, 1, rp), c["theta"])[:, :, 0]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope].float(),
                           kv[..., :nope].float())
              + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), k_pe.float())) \
        / math.sqrt(nope + rp)
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~keep, -1e30), dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", w, kv[..., nope:])
    return o.reshape(b, s, h * vd) @ p["wo"].to(dt)


def _swiglu(x, wg, wu, wd, dt) -> torch.Tensor:
    return (F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))) @ wd.to(dt)


def experts(p: Dict[str, torch.Tensor], x: torch.Tensor, c: dict, dt,
            bias: Optional[torch.Tensor] = None, shared: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One expert layer (its leaves unstacked) on x (B, S, d): (the held
    experts' gated part plus, with ``shared``, the shared experts; the
    balance term of each sequence (B,)).  ``bias``: the selection bias
    (E,), zero when None."""
    b, s, d = x.shape
    e, k = c["experts"], c["top_k"]
    xf = x.reshape(-1, d)
    lg = xf.float() @ p["router"].float()
    sc = torch.sigmoid(lg)
    pick = sc.detach() if bias is None else sc.detach() + bias
    # the top k of s + b, ties (s rounds to 1.0) broken by the larger logit
    by_lg = torch.argsort(lg.detach(), dim=-1, descending=True, stable=True)
    idx = by_lg.gather(1, torch.argsort(pick.gather(1, by_lg), dim=-1,
                                        descending=True, stable=True)[:, :k])
    g = sc.gather(1, idx)
    g = g / (g.sum(dim=-1, keepdim=True) + 1e-20) * c["scale"]
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for j in range(c["held"]):
        hit = idx == c["first"] + j
        tok = hit.any(dim=-1).nonzero()[:, 0]
        gate = (g * hit).sum(dim=-1)[tok]
        ye = _swiglu(xf[tok], p["wg"][j], p["wu"][j], p["wd"][j], dt)
        y = y.index_add(0, tok, gate[:, None] * ye.float())
    y = y.to(dt)
    if shared and "shared_wg" in p:
        y = y + _swiglu(xf, p["shared_wg"], p["shared_wu"], p["shared_wd"],
                        dt)
    count = torch.zeros(b * s, e, device=x.device).scatter(1, idx, 1.0) \
        .view(b, s, e).sum(dim=1)
    share = (sc / sc.sum(dim=-1, keepdim=True)).view(b, s, e).mean(dim=1)
    return y.view(b, s, d), (count * (e / (k * s)) * share).sum(dim=-1)


def nll_sum(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: dict, biases: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the rows' negative log-likelihoods, sum over the rows'
    sequences of their balance terms, summed over the layers).
    ``biases``: each expert layer's selection bias, zero when None."""
    c = dims(cfg)
    dt = getattr(torch, cfg["compute_dtype"])
    # one unbind a stacked leaf: its backward is one stack, not a
    # full-size scatter a layer
    per_layer = {k: t.unbind(0) for k, t in p.items()
                 if k.startswith("blocks.")}
    x = F.embedding(batch["tokens"].long(), p["embed"]).to(dt)
    aux = torch.zeros((), device=x.device)
    for layer in range(c["layers"]):
        moe = layer >= c["lead"]
        pre, i = ("blocks.l0.", layer - c["lead"]) if moe else \
            ("blocks.first.", layer)
        lp = {k[len(pre):]: v[i] for k, v in per_layer.items()
              if k.startswith(pre)}
        x = x + mla({k[6:]: v for k, v in lp.items()
                      if k.startswith("mixer.")},
                    _rms(x, lp["norm1"], c["eps"]), c, dt)
        a = _rms(x, lp["norm2"], c["eps"])
        ffn = {k[4:]: v for k, v in lp.items() if k.startswith("ffn.")}
        if moe:
            y, bal = experts(ffn, a, c, dt,
                             None if biases is None else biases[i])
            aux = aux + bal.sum()
        else:
            y = _swiglu(a, ffn["wg"], ffn["wu"], ffn["wd"], dt)
        x = x + y
    x = _rms(x, p["norm_f"], c["eps"])
    logits = x.float() @ p["w_out"].float()
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= cfg["vocab"], -1e30)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    return nll.sum(), aux


def loss_and_grads(params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg: dict, rows: int,
                   share: Tuple[int, int] = (0, 1)
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean next-token loss, float32 gradient of every leaf of the loss
    plus ``assumed.aux_weight`` times the balance terms' batch mean) of
    one rank's batch, over blocks of ``rows`` sequences, each block's
    backward adding its share into the leaves' ``.grad``.  ``share``
    must be (0, 1): the reference runs at tp 1."""
    if share != (0, 1):
        raise ValueError("MLA and the dropless expert layer run at tp 1")
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    n = batch["labels"].shape[0]
    denom = float(batch["labels"].numel())
    w = cfg["assumed"]["aux_weight"]
    total = 0.0
    for lo in range(0, n, rows):
        part = {k: v[lo:lo + rows] for k, v in batch.items()}
        nll, aux = nll_sum(p, part, cfg)
        loss = nll / denom
        (loss + w * aux / n).backward()
        total += float(loss.detach())
    return total, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                   for k, v in p.items()}
