"""Plain PyTorch reference of the pre-norm transformer the configurations
run: the BERT encoder (bidirectional, GELU MLP, MLM loss) and the dense
GQA decoder of InternLM2 (causal, SwiGLU MLP, next-token loss).

It follows the model as the configuration file states it: RMSNorm with
its variance in float32, rotary position embeddings (rotate-half, base
``rope_theta``), the block matmuls in ``compute_dtype`` with float32
weights rounded to it, attention scores and softmax in float32, the LM
head in float32 over the vocabulary padded to a multiple of 8 * tp with
the padded columns masked out, and the loss the mean negative
log-likelihood over the loss mask.  BERT's learned positions and
LayerNorm are replaced by rotary positions and RMSNorm, as in the
configuration.

The parameter tree is the flat layout the optimizer works on: every leaf
a float32 tensor, the per-layer leaves stacked on a leading layer axis,
the leaves in sorted order of their dotted paths.  Under tensor
parallelism a model rank holds the contiguous shard of each split leaf
along ``split`` and the whole of each replicated leaf; its flat vector is
the concatenation of its shards in that order, zero-padded.

Nothing here imports the program: it is plain torch, with no kernel,
cache or batching of its own.  Gradients are taken by autograd over row
blocks of the batch, summed in float32.
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


def padded_vocab(cfg: dict, tp: int = 1) -> int:
    q = 8 * tp
    return (cfg["vocab"] + q - 1) // q * q


def head_dim(cfg: dict) -> int:
    return cfg["d_model"] // cfg["n_heads"]


def leaves(cfg: dict, tp: int = 1) -> List[Leaf]:
    """Every global leaf in flat order, with its split dim and init law."""
    if cfg["n_heads"] % tp or cfg["n_kv_heads"] % tp:
        raise ValueError("the reference shards heads evenly over the model "
                         "axis only")
    L, d, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    hd = head_dim(cfg)
    hq, hkv, vp = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, \
        padded_vocab(cfg, tp)
    out = [Leaf("blocks.l0.ffn.wd", (L, ff, d), 1, "fan_in"),
           Leaf("blocks.l0.ffn.wg", (L, d, ff), 2, "fan_in")]
    if cfg["mlp_kind"] == "swiglu":
        out.append(Leaf("blocks.l0.ffn.wu", (L, d, ff), 2, "fan_in"))
    out += [Leaf("blocks.l0.mixer.wk", (L, d, hkv), 2, "fan_in"),
            Leaf("blocks.l0.mixer.wo", (L, hq, d), 1, "fan_in"),
            Leaf("blocks.l0.mixer.wq", (L, d, hq), 2, "fan_in"),
            Leaf("blocks.l0.mixer.wv", (L, d, hkv), 2, "fan_in"),
            Leaf("blocks.l0.norm1", (L, d), None, "ones"),
            Leaf("blocks.l0.norm2", (L, d), None, "ones"),
            Leaf("embed", (vp, d), 0, "embed"),
            Leaf("norm_f", (d,), None, "ones"),
            Leaf("w_out", (d, vp), 1, "fan_in")]
    return out


def shard_shape(leaf: Leaf, tp: int) -> Tuple[int, ...]:
    if leaf.split is None or tp == 1:
        return leaf.shape
    s = list(leaf.shape)
    s[leaf.split] //= tp
    return tuple(s)


def n_params(cfg: dict, tp: int = 1) -> int:
    return sum(math.prod(lf.shape) for lf in leaves(cfg, tp))


def shard_sizes(cfg: dict, tp: int = 1) -> List[int]:
    """Element counts of one model rank's leaves, in flat order."""
    return [math.prod(shard_shape(lf, tp)) for lf in leaves(cfg, tp)]


def unflatten(flat: torch.Tensor, cfg: dict, tp: int = 1
              ) -> Dict[str, torch.Tensor]:
    """Views of a flat vector of the global leaves at ``tp`` as the
    leaves."""
    out, off = {}, 0
    for lf in leaves(cfg, tp):
        n = math.prod(lf.shape)
        out[lf.path] = flat[off:off + n].view(lf.shape)
        off += n
    return out


def shard_flat(params: Dict[str, torch.Tensor], cfg: dict, tp: int,
               rank: int, d_pad: int) -> torch.Tensor:
    """Model rank ``rank``'s flat vector of the global leaves ``params``,
    zero-padded to ``d_pad`` (float32, on the leaves' device)."""
    parts = []
    for lf in leaves(cfg, tp):
        t = params[lf.path]
        if lf.split is not None and tp > 1:
            size = lf.shape[lf.split] // tp
            t = t.narrow(lf.split, rank * size, size)
        parts.append(t.reshape(-1).to(torch.float32))
    flat = torch.cat(parts)
    return F.pad(flat, (0, d_pad - flat.shape[0]))


def join_shards(flats: List[torch.Tensor], cfg: dict, tp: int
                ) -> Dict[str, torch.Tensor]:
    """The global leaves from every model rank's flat vector (rank
    order): split leaves concatenated, replicated ones rank 0's."""
    out = {}
    offs = [0] * len(flats)
    for lf in leaves(cfg, tp):
        n = math.prod(shard_shape(lf, tp))
        pieces = [f[o:o + n].view(shard_shape(lf, tp))
                  for f, o in zip(flats, offs)]
        offs = [o + n for o in offs]
        out[lf.path] = pieces[0] if lf.split is None or tp == 1 else \
            torch.cat(pieces, dim=lf.split)
    return out


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by its position along S (rotate-half)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    c, sn = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c],
                     dim=-1).to(x.dtype)


def _layer(p: Dict[str, Tuple[torch.Tensor, ...]], i: int, x: torch.Tensor,
           cfg: dict, dt) -> torch.Tensor:
    """Layer ``i`` of the stack; ``p`` maps each stacked leaf to its
    per-layer slices."""
    b, s, d = x.shape
    hd, nh, nkv = head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    eps = cfg["norm_eps"]
    a = _rms(x, p["blocks.l0.norm1"][i], eps)
    q = (a @ p["blocks.l0.mixer.wq"][i].to(dt)).view(b, s, nh, hd)
    k = (a @ p["blocks.l0.mixer.wk"][i].to(dt)).view(b, s, nkv, hd)
    v = (a @ p["blocks.l0.mixer.wv"][i].to(dt)).view(b, s, nkv, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    if cfg["causal"]:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, -1e30)
    w = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, nh * hd)
    x = x + o @ p["blocks.l0.mixer.wo"][i].to(dt)
    a = _rms(x, p["blocks.l0.norm2"][i], eps)
    if cfg["mlp_kind"] == "gelu":
        h = F.gelu(a @ p["blocks.l0.ffn.wg"][i].to(dt), approximate="tanh")
    else:
        h = F.silu(a @ p["blocks.l0.ffn.wg"][i].to(dt)) \
            * (a @ p["blocks.l0.ffn.wu"][i].to(dt))
    return x + h @ p["blocks.l0.ffn.wd"][i].to(dt)


def nll_sum(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: dict) -> torch.Tensor:
    """Sum over the loss mask of the rows' negative log-likelihoods."""
    dt = getattr(torch, cfg["compute_dtype"])
    # one unbind a stacked leaf: its backward is one stack, not a
    # full-size scatter a layer
    per_layer = {k: t.unbind(0) for k, t in p.items()
                 if k.startswith("blocks.")}
    x = F.embedding(batch["tokens"].long(), p["embed"]).to(dt)
    for i in range(cfg["n_layers"]):
        x = _layer(per_layer, i, x, cfg, dt)
    x = _rms(x, p["norm_f"], cfg["norm_eps"])
    logits = x.float() @ p["w_out"].float()
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= cfg["vocab"], -1e30)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    return nll.sum() if mask is None else (nll * mask).sum()


def loss_and_grads(params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg: dict, rows: int,
                   share: Tuple[int, int] = (0, 1)
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean loss, float32 gradient of every leaf) of one rank's batch,
    taken over blocks of ``rows`` sequences: each block's backward adds
    its share of the mean into the leaves' ``.grad``.  ``share = (i, n)``
    takes the blocks ``i, i + n, ...`` alone: the sum of the ``n`` shares
    is the whole."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    mask = batch.get("loss_mask")
    denom = float(max(mask.sum().item(), 1.0)) if mask is not None else \
        float(batch["labels"].numel())
    n = batch["labels"].shape[0]
    total = 0.0
    for b, lo in enumerate(range(0, n, rows)):
        if b % share[1] != share[0]:
            continue
        part = {k: v[lo:lo + rows] for k, v in batch.items()}
        loss = nll_sum(p, part, cfg) / denom
        loss.backward()
        total += float(loss.detach())
    return total, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                   for k, v in p.items()}
