"""The transformer: parameter layout, init, the training module and loss
(the BERT encoder, slice 1), and the serving forward passes of the dense
decoders (``prefill``, ``init_caches``, ``decode_step``; slice 2).

Parameters keep the reference's shapes and order: ``(d_in, d_out)``
weights, the per-layer leaves stacked on a leading layer axis under
``blocks.l0``, and the ``ravel_pytree`` order of ``repro`` (sorted keys at
every level: ``blocks.l0.{ffn.{wd,wg}, mixer.{wk,wo,wq,wv}, norm1, norm2}``,
``embed``, ``norm_f``, ``w_out``; each leaf in C order).  So one flat f32
vector holds every parameter at the same offset as the reference's flat
vector, and the 4096-element scale blocks of the compressor cover the same
elements.

:class:`Transformer` is built over such a flat vector: each of its
``nn.Parameter``s is a view of it (layer ``i`` of a stacked leaf is the
``i``-th slice), so an update of the flat vector is an update of the
model.  :meth:`Transformer.bind_grads` points every parameter's ``.grad``
at the matching view of a flat gradient buffer, into which autograd then
accumulates in place: the backward pass writes the flat gradient directly.

The serving functions take the params as the dict from dotted path to
tensor (``init_params``, ``convert.params_from_jax``) with the layers
stacked on the leading axis, and return the decode caches stacked the same
way, ``{"l0": {"k", "v"}}`` of shape (L, B, S_c, Hkv, hd), as the
reference's ``prefill`` / ``decode_step`` do.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models.attention import attn_forward
from repro_torch.models.common import dense, rms_norm
from repro_torch.models.mlp import mlp_forward

Shapes = List[Tuple[str, Tuple[int, ...]]]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in ("encoder", "dense"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(the port has the BERT encoder and the "
                                  "dense decoders)")
    if cfg.embed_kind != "tokens":
        raise NotImplementedError(f"embed_kind {cfg.embed_kind!r} is not "
                                  "ported yet")


def leaf_shapes(cfg: ArchConfig) -> Shapes:
    """(dotted path, shape) of every parameter leaf in ravel order."""
    _check_supported(cfg)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd = cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    vp = cfg.padded_vocab(1)
    ffn = {"wg": (L, d, ff), "wd": (L, ff, d)}
    if cfg.mlp_kind == "swiglu":
        ffn["wu"] = (L, d, ff)
    tree = {
        "blocks": {"l0": {
            "norm1": (L, d), "norm2": (L, d),
            "mixer": {"wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv),
                      "wo": (L, q, d)},
            "ffn": ffn,
        }},
        "norm_f": (d,), "w_out": (d, vp), "embed": (vp, d),
    }
    out: Shapes = []

    def walk(node, prefix):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], prefix + k + ".")
            else:
                out.append((prefix + k, node[k]))
    walk(tree, "")
    return out


def flat_size(cfg: ArchConfig) -> int:
    return sum(math.prod(s) for _, s in leaf_shapes(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Random f32 parameters with the reference's distributions (norm
    scales 1, linear weights N(0, 1/d_in), ``w_out`` N(0, 1/d), ``embed``
    N(0, 0.02^2)), drawn from ``generator`` in ravel order."""
    params = {}
    for path, shape in leaf_shapes(cfg):
        leaf = path.rsplit(".", 1)[-1]
        if leaf.startswith("norm"):
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=generator,
                            device=generator.device)
            scale = 0.02 if leaf == "embed" else shape[-2] ** -0.5
            t = t * scale
        params[path] = t.to(device=device, dtype=torch.float32)
    return params


def _sub(views: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of ``views`` under ``prefix``, with it stripped."""
    return {p[len(prefix):]: v for p, v in views.items()
            if p.startswith(prefix)}


class Block(nn.Module):
    """One pre-norm residual layer."""

    def __init__(self, cfg: ArchConfig, views: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.Parameter(views["norm1"])
        self.norm2 = nn.Parameter(views["norm2"])
        self.mixer = nn.ParameterDict(
            {k: nn.Parameter(t) for k, t in _sub(views, "mixer.").items()})
        self.ffn = nn.ParameterDict(
            {k: nn.Parameter(t) for k, t in _sub(views, "ffn.").items()})

    def forward_params(self) -> List[nn.Parameter]:
        """The layer's parameters in the order ``forward`` first uses
        them."""
        return [self.norm1] + [self.mixer[k] for k in
                               ("wq", "wk", "wv", "wo")] + \
            [self.norm2] + [self.ffn[k] for k in ("wg", "wu", "wd")
                            if k in self.ffn]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        x = x + attn_forward(self.mixer, rms_norm(x, self.norm1, eps),
                             self.cfg)
        return x + mlp_forward(self.ffn, rms_norm(x, self.norm2, eps),
                               self.cfg)


class Transformer(nn.Module):
    """The encoder over a flat f32 parameter vector (see module doc)."""

    def __init__(self, cfg: ArchConfig, flat: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        shapes = leaf_shapes(cfg)
        need = sum(math.prod(s) for _, s in shapes)
        if flat.dtype != torch.float32 or flat.ndim != 1 \
                or flat.shape[0] < need:
            raise ValueError(f"flat parameters: need float32 (>= {need},), "
                             f"got {flat.dtype} {tuple(flat.shape)}")
        views, off = {}, 0
        for path, shape in shapes:
            n = math.prod(shape)
            views[path] = flat[off:off + n].view(shape)
            off += n
        per_layer = [{p: v[i] for p, v in _sub(views, "blocks.l0.").items()}
                     for i in range(cfg.n_layers)]
        self.blocks = nn.ModuleList(Block(cfg, lv) for lv in per_layer)
        self.embed = nn.Parameter(views["embed"])
        self.norm_f = nn.Parameter(views["norm_f"])
        self.w_out = nn.Parameter(views["w_out"])
        self._flat = flat

    def grad_order(self) -> List[nn.Parameter]:
        """Every parameter in the order backward completes its gradient:
        the reverse of the order ``loss_fn`` first uses them (a static
        order, the same on every rank: ``w_out`` first, ``embed`` last)."""
        fwd = [self.embed]
        for blk in self.blocks:
            fwd += blk.forward_params()
        return list(reversed(fwd + [self.norm_f, self.w_out]))

    def bind_grads(self, flat_grad: torch.Tensor) -> None:
        """Point every parameter's ``.grad`` at the view of ``flat_grad`` at
        the parameter's offset in the flat vector."""
        if flat_grad.shape != self._flat.shape or \
                flat_grad.device != self._flat.device:
            raise ValueError("flat_grad must match the flat parameters")
        base = self._flat.data_ptr()
        for p in self.parameters():
            off = (p.data_ptr() - base) // p.element_size()
            p.grad = flat_grad[off:off + p.numel()].view(p.shape)

    def forward(self, batch: Dict[str, torch.Tensor]):
        return loss_fn(self, batch)


def vocab_parallel_xent(x: torch.Tensor, w_out: torch.Tensor,
                        labels: torch.Tensor, mask: torch.Tensor,
                        cfg: ArchConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over the (single-shard) vocab: f32 logits, padded vocab
    columns masked to -1e30 before the partition function.  Returns
    (mean loss, mean greedy accuracy) over ``mask``."""
    logits = x.to(torch.float32) @ w_out.to(torch.float32)
    v = logits.shape[-1]
    keep = torch.arange(v, device=logits.device) < cfg.vocab
    logits = torch.where(keep, logits, -1e30)
    m = logits.max(dim=-1).values.detach()
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    ll = logits.gather(-1, labels.clamp(0, v - 1)[..., None].long())[..., 0]
    nll = torch.log(se) + m - ll
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    correct = ((ll.detach() - m).abs() < 1e-6) & (mask > 0)
    acc = correct.sum() / denom
    return loss, acc


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """Training loss of this rank's batch: (total, {"loss", "aux", "acc"}).
    A dense encoder has no auxiliary loss, so total == loss."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    h = F.embedding(batch["tokens"].long(), model.embed).to(dtype)
    for blk in model.blocks:
        h = checkpoint(blk, h, use_reentrant=False) if cfg.remat else blk(h)
    h = rms_norm(h, model.norm_f, cfg.norm_eps)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss, acc = vocab_parallel_xent(h, model.w_out, labels, mask, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"loss": loss, "aux": zero, "acc": acc}


# --------------------------------------------------------------------------
# serving: prefill and KV-cached decode
# --------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]


def _layers(params: Params, cfg: ArchConfig) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked block params:
    ``[{"norm1", "norm2", "mixer": {...}, "ffn": {...}}, ...]``."""
    blocks = _sub(params, "blocks.l0.")
    return [{"norm1": blocks["norm1"][i], "norm2": blocks["norm2"][i],
             "mixer": {k: t[i] for k, t in _sub(blocks, "mixer.").items()},
             "ffn": {k: t[i] for k, t in _sub(blocks, "ffn.").items()}}
            for i in range(cfg.n_layers)]


def check_serving(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is an arch the serving path takes."""
    _check_supported(cfg)
    if cfg.family == "encoder":
        raise ValueError("encoder-only archs do not decode")


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
    """Prefill forward: last-position logits (B, V_pad) in the compute
    dtype and the decode caches seeded from the sequence.

    ``cache_len``: total KV-cache capacity (>= prompt length) so decode
    steps have slots to append into; a windowed arch whose prompt is
    longer than the window gets a ring buffer of the window instead, as
    in the reference."""
    check_serving(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    tokens = batch["tokens"]
    h = F.embedding(tokens.long(), params["embed"]).to(dtype)
    b, s = tokens.shape
    if cfg.window and s > cfg.window:
        s_c = cfg.window
    else:
        s_c = max(s, cache_len or 0)
    shape = (cfg.n_layers, b, s_c, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=h.device),
             "v": torch.zeros(shape, dtype=dtype, device=h.device)}
    eps = cfg.norm_eps
    for i, p in enumerate(_layers(params, cfg)):
        y, (k, v) = attn_forward(p["mixer"], rms_norm(h, p["norm1"], eps),
                                 cfg, return_kv=True)
        if cfg.window and s > cfg.window:
            slots = torch.arange(s - s_c, s, device=h.device) % s_c
            cache["k"][i][:, slots] = k[:, s - s_c:]
            cache["v"][i][:, slots] = v[:, s - s_c:]
        else:
            cache["k"][i][:, :s] = k
            cache["v"][i][:, :s] = v
        h = h + y
        h = h + mlp_forward(p["ffn"], rms_norm(h, p["norm2"], eps), cfg)
    h = rms_norm(h, params["norm_f"], eps)
    logits = dense(h[:, -1, :], params["w_out"])
    return logits, {"l0": cache}


def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, device="cpu") -> Any:
    """Zero decode caches, stacked over the layers."""
    one = A.init_kv_cache(cfg, batch, seq_len, dtype, device)
    return {"l0": {k: t[None].repeat(cfg.n_layers, *([1] * t.ndim))
                   for k, t in one.items()}}


def decode_step(params: Params, batch: Dict[str, torch.Tensor], caches: Any,
                pos: int, cfg: ArchConfig) -> Tuple[torch.Tensor, Any]:
    """One decode step: one new token per sequence against the caches.

    batch: {"tokens": (B, 1)}; ``pos`` is the new token's absolute
    position.  Updates ``caches`` in place and returns (logits (B, V_pad),
    caches)."""
    check_serving(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    h = F.embedding(batch["tokens"].long(), params["embed"]).to(dtype)
    cache = caches["l0"]
    eps = cfg.norm_eps
    for i, p in enumerate(_layers(params, cfg)):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        h = h + A.decode_attn(p["mixer"], rms_norm(h, p["norm1"], eps),
                              layer_cache, pos, cfg)
        h = h + mlp_forward(p["ffn"], rms_norm(h, p["norm2"], eps), cfg)
    h = rms_norm(h, params["norm_f"], eps)
    logits = dense(h[:, -1, :], params["w_out"])
    return logits, caches
