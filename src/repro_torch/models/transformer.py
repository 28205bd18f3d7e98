"""The transformer: parameter layout, init, the training module and loss
(every family: the BERT encoder, the dense and MoE decoders, the Mamba-1
SSM, the Jamba hybrid, the audio and VLM input stubs, at any tensor-
parallel degree), and the serving forward passes of every decoding family
at any tensor-parallel degree (``prefill``, ``init_caches``,
``cache_specs``, ``shard_caches``, ``decode_step``).

Parameters keep the reference's shapes and order: ``(d_in, d_out)``
weights, the per-layer leaves stacked on a leading superblock axis under
``blocks.l{i}`` (``i`` the layer's place in the superblock: one layer for
every family but the hybrid, whose superblock is ``attn_every`` layers),
and the ``ravel_pytree`` order of ``repro`` (sorted keys at every level:
``blocks.l0.{ffn.{wd,wg}, mixer.{wk,wo,wq,wv}, norm1, norm2}``, ``embed``,
``norm_f``, ``w_out``; each leaf in C order).  So one flat f32 vector
holds every parameter at the same offset as the reference's flat vector,
and the 4096-element scale blocks of the compressor cover the same
elements.

Tensor parallelism: the reference's global tree depends on tp (q heads
padded to a multiple of tp, the vocab to a multiple of 8 * tp, kv heads
repeated when n_kv < tp, MoE ff slices when E < tp; ``global_leaf_shapes``)
and ``param_specs`` names, for every leaf, the dim split over the model
axis (None: replicated).  A model rank holds the contiguous shard of each
leaf (``leaf_shapes(cfg, tp)``), and its flat vector is the ravel-order
concatenation of its shards, as the reference's per-rank ``ravel_pytree``
inside ``shard_map``.  The forward places the Megatron collectives of
``models.common`` by hand (``ParallelCtx``): the embedding and the LM head
are vocab-parallel (the cross-entropy takes the max over the model axis
and masks the padded columns), and under sequence parallelism the
residual stream between blocks is split along the sequence, each block
boundary an all-gather / reduce-scatter pair.

:class:`Transformer` is built over such a flat vector: each of its
``nn.Parameter``s is a view of it (superblock ``s`` of a stacked leaf is
its ``s``-th slice), so an update of the flat vector is an update of the
model.  :meth:`Transformer.bind_grads` points every parameter's ``.grad``
at the matching view of a flat gradient buffer, into which autograd then
accumulates in place: the backward pass writes the flat gradient
directly.  With ``cfg.remat`` each superblock is recomputed in backward,
as the reference's ``jax.checkpoint`` of its scan body; with
``remat_policy="dots"`` the recompute keeps the outputs of the products
without batch dimensions (``models.common.save_dots``).

The serving functions take the params as the dict from dotted path to
tensor (``init_params``, ``convert.params_from_jax``) with the layers
stacked on the leading superblock axis, and return the decode caches in
the reference's tree, each leaf stacked the same way: ``{"l{i}": {"k",
"v"}}`` (B, S_c, Hkv, hd) for an attention layer, ``{"l{i}": {"h",
"conv"}}`` (B, di, N) f32 and (B, K-1, di) for an SSM layer, ``i`` the
layer's place in the superblock (a dense arch: ``{"l0": {"k", "v"}}`` of
shape (L, B, S_c, Hkv, hd)).  ``decode_step`` advances them in place.
Under tensor parallelism (``ctx``) the params are a model rank's shards,
its caches hold its kv heads and SSM channels (``cache_specs``), and the
logits are its shard of the padded vocab.
Every family decodes but the encoders; the audio stub takes
``{"embeddings"}``, the others ``{"tokens"}`` (the VLM's prefill also
``{"patch_embeds"}``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import shard_leaf
from repro_torch.kernels.lm_head_xent.ops import lm_head_xent
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S
from repro_torch.models.attention import attn_forward
from repro_torch.models.common import (MODEL_AXIS, NO_TP, ParallelCtx,
                                       dense, f_reduce, g_copy, rep_param,
                                       rms_norm, save_dots,
                                       sp_gather, sp_scatter, sp_slice,
                                       tp_rank)
from repro_torch.models.mlp import mlp_forward, moe_forward
from repro_torch.obs.trace import BLOCK_SPAN, count_collective, scope

Shapes = List[Tuple[str, Tuple[int, ...]]]


def superblock_layout(cfg: ArchConfig) -> List[Tuple[str, Optional[str]]]:
    """(mixer, ffn) of each layer of one superblock: ``("ssm", None)`` for
    the SSM; ``attn_every`` layers for the hybrid (attention where
    ``is_attn_layer``, MoE where ``is_moe_layer``); ``("attn", "moe" |
    "dense")`` otherwise."""
    if cfg.family == "ssm":
        return [("ssm", None)]
    if cfg.family == "hybrid":
        return [("attn" if cfg.is_attn_layer(i) else "ssm",
                 "moe" if cfg.is_moe_layer(i) else "dense")
                for i in range(cfg.attn_every)]
    return [("attn", "moe" if cfg.n_experts else "dense")]


def n_superblocks(cfg: ArchConfig) -> int:
    per = len(superblock_layout(cfg))
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"superblocks of {per}")
    return cfg.n_layers // per


def _layer_shapes(cfg: ArchConfig, n: int, mixer: str,
                  ffn: Optional[str], tp: int = 1) -> dict:
    """The global leaves of one layer kind at ``tp``, stacked over ``n``
    superblocks."""
    def stacked(shapes):
        return {k: (n,) + v for k, v in shapes.items()}
    tree = {"norm1": (n, cfg.d_model),
            "mixer": stacked(A.attn_shapes(cfg, tp) if mixer == "attn"
                             else S.ssm_shapes(cfg))}
    if ffn is not None:
        tree["ffn"] = stacked(M.moe_shapes(cfg, tp) if ffn == "moe"
                              else M.mlp_shapes(cfg))
        tree["norm2"] = (n, cfg.d_model)
    return tree


def _layer_specs(cfg: ArchConfig, mixer: str, ffn: Optional[str]) -> dict:
    """The split dim of each leaf of one layer kind, stacked (so every
    split dim moves one to the right)."""
    def stacked(specs):
        return {k: None if v is None else v + 1 for k, v in specs.items()}
    tree = {"norm1": None,
            "mixer": stacked(A.attn_param_specs(cfg) if mixer == "attn"
                             else S.ssm_param_specs(cfg))}
    if ffn is not None:
        tree["norm2"] = None
        tree["ffn"] = stacked(M.moe_param_specs(cfg) if ffn == "moe"
                              else M.mlp_param_specs(cfg))
    return tree


def _walk(tree, prefix="", out=None) -> list:
    """(dotted path, leaf) of a nested dict in ravel order."""
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _walk(tree[k], prefix + k + ".", out)
        else:
            out.append((prefix + k, tree[k]))
    return out


def global_leaf_shapes(cfg: ArchConfig, tp: int = 1) -> Shapes:
    """(dotted path, shape) of every leaf of the reference's global tree at
    ``tp``, in ravel order."""
    nsb = n_superblocks(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab(tp)
    tree = {
        "blocks": {f"l{i}": _layer_shapes(cfg, nsb, mx, ff, tp)
                   for i, (mx, ff) in enumerate(superblock_layout(cfg))},
        "norm_f": (d,), "w_out": (d, vp),
    }
    if cfg.embed_kind in ("tokens", "prefix"):
        tree["embed"] = (vp, d)
    return _walk(tree)


def param_specs(cfg: ArchConfig) -> Dict[str, Optional[int]]:
    """{dotted path: the dim split over the model axis, or None}: the
    reference's ``param_specs`` (the vocab-parallel ``w_out`` columns and
    ``embed`` rows; the column- and row-parallel projections; the MoE
    expert blocks; norms and routers replicated)."""
    tree = {"blocks": {f"l{i}": _layer_specs(cfg, mx, ff)
                       for i, (mx, ff) in
                       enumerate(superblock_layout(cfg))},
            "norm_f": None, "w_out": 1}
    if cfg.embed_kind in ("tokens", "prefix"):
        tree["embed"] = 0
    return dict(_walk(tree))


def leaf_shapes(cfg: ArchConfig, tp: int = 1) -> Shapes:
    """(dotted path, shape) of every leaf a model rank holds at ``tp`` (its
    shard of the global leaf), in ravel order."""
    specs = param_specs(cfg)
    out: Shapes = []
    for path, shape in global_leaf_shapes(cfg, tp):
        dim = specs[path]
        if dim is not None:
            if shape[dim] % tp:
                raise ValueError(f"{path} {shape}: dim {dim} does not split "
                                 f"over {tp} model ranks")
            shape = shape[:dim] + (shape[dim] // tp,) + shape[dim + 1:]
        out.append((path, shape))
    return out


def flat_size(cfg: ArchConfig, tp: int = 1) -> int:
    """Parameters a model rank holds (the flat vector before padding)."""
    return sum(math.prod(s) for _, s in leaf_shapes(cfg, tp))


def _draw(cfg: ArchConfig, path: str, shape, tp: int,
          generator: torch.Generator) -> torch.Tensor:
    """One global leaf with the reference's distribution."""
    leaf = path.rsplit(".", 1)[-1]
    if leaf.startswith("norm"):
        return torch.ones(shape)
    if leaf in S.SPECIAL_LEAVES:
        return S.init_leaf(leaf, shape, generator)
    dev = generator.device
    if leaf in ("wk", "wv") and ".mixer." in path:
        rep = A.shard_dims(cfg, tp)[2]
        if rep > 1:
            # n_kv < tp: one draw of the kv heads, each repeated rep times
            n, d = shape[:2]
            t = _draw(cfg, path, (n, d, cfg.n_kv_heads * cfg.head_dim), 1,
                      generator)
            return t.reshape(n, d, cfg.n_kv_heads, 1, cfg.head_dim).expand(
                n, d, cfg.n_kv_heads, rep, cfg.head_dim).reshape(shape)
    t = torch.randn(shape, generator=generator, device=dev)
    if leaf in ("embed", "router"):
        scale = 0.02
    elif leaf == "wd" and len(shape) == 4:
        scale = cfg.d_ff ** -0.5          # an expert's slice of d_ff
    else:
        scale = shape[-2] ** -0.5
    return t * scale


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cpu", tp: int = 1, rank: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Random f32 parameters with the reference's distributions (norm
    scales 1, linear weights and expert stacks N(0, 1/d_in), ``w_out``
    N(0, 1/d), ``embed`` and the MoE router N(0, 0.02^2), the SSM's own
    leaves as ``ssm.init_leaf``), drawn from ``generator`` in ravel order
    at the global shapes of ``tp``.  ``rank`` given: model rank ``rank``'s
    shards only, each global leaf drawn whole and then cut, so every
    rank of one seed holds its part of one global model."""
    specs = param_specs(cfg)
    params = {}
    for path, shape in global_leaf_shapes(cfg, tp):
        t = _draw(cfg, path, shape, tp, generator)
        if rank is not None:
            t = shard_leaf(t, specs[path], tp, rank)
        params[path] = t.to(device=device, dtype=torch.float32)
    return params


def init_layer(cfg: ArchConfig, sub: str, shapes: Dict[str, Tuple[int, ...]],
               generator: torch.Generator, tp: int = 1
               ) -> Dict[str, torch.Tensor]:
    """One layer's global leaves of ``shapes`` (unstacked), drawn as
    :func:`init_params` draws the stacked ``blocks.l0.<sub>`` leaves, in
    ravel order: the per-module ``init_*`` views."""
    return {k: _draw(cfg, f"blocks.l0.{sub}.{k}", (1,) + tuple(shapes[k]),
                     tp, generator)[0].float()
            for k in sorted(shapes)}


def _sub(views: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of ``views`` under ``prefix``, with it stripped."""
    return {p[len(prefix):]: v for p, v in views.items()
            if p.startswith(prefix)}


# the order in which each layer kind's forward first uses its leaves
_FORWARD_ORDER = {
    "attn": ("wq", "wk", "wv", "wo"),
    "ssm": ("in_proj_x", "in_proj_z", "conv_w", "x_proj", "dt_proj",
            "dt_bias", "A_log", "D", "out_proj"),
    "dense": ("wg", "wu", "wd"),
    "moe": ("router", "wg", "wu", "wd"),
}


class Block(nn.Module):
    """One pre-norm residual layer: a mixer (``"attn"`` | ``"ssm"``) and,
    but for the SSM's layers, an FFN (``"dense"`` | ``"moe"``)."""

    def __init__(self, cfg: ArchConfig, views: Dict[str, torch.Tensor],
                 mixer: str, ffn: Optional[str], ctx: ParallelCtx = NO_TP):
        super().__init__()
        self.cfg, self.mixer_kind, self.ffn_kind = cfg, mixer, ffn
        self.ctx = ctx
        self.norm1 = nn.Parameter(views["norm1"])
        self.mixer = nn.ParameterDict(
            {k: nn.Parameter(t) for k, t in _sub(views, "mixer.").items()})
        self.norm2 = nn.Parameter(views["norm2"]) if ffn else None
        self.ffn = nn.ParameterDict(
            {k: nn.Parameter(t) for k, t in _sub(views, "ffn.").items()})

    def forward_params(self) -> List[nn.Parameter]:
        """The layer's parameters in the order ``forward`` first uses
        them."""
        out = [self.norm1] + [self.mixer[k] for k in
                              _FORWARD_ORDER[self.mixer_kind]]
        if self.ffn_kind:
            out += [self.norm2] + [self.ffn[k] for k in
                                   _FORWARD_ORDER[self.ffn_kind]
                                   if k in self.ffn]
        return out

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x, the MoE layer's aux loss or None).  Under sequence
        parallelism x is this rank's chunk of the sequence, and each
        sublayer runs on the gathered sequence between an ``sp_gather`` and
        an ``sp_scatter``."""
        eps, cfg, ctx = self.cfg.norm_eps, self.cfg, self.ctx
        outer = "none" if ctx.sp else "tp"
        h = rms_norm(x, rep_param(self.norm1, ctx), eps)
        h_in = sp_gather(h, ctx) if ctx.sp else h
        if self.mixer_kind == "attn":
            y = attn_forward(self.mixer, h_in, cfg, ctx=ctx, outer=outer)
        else:
            y = S.ssm_forward(self.mixer, h_in, cfg, ctx=ctx, outer=outer)
        x = x + (sp_scatter(y, ctx) if ctx.sp else y)
        aux = None
        if self.ffn_kind is not None:
            h = rms_norm(x, rep_param(self.norm2, ctx), eps)
            h_in = sp_gather(h, ctx) if ctx.sp else h
            if self.ffn_kind == "moe":
                y, aux = moe_forward(self.ffn, h_in, cfg, ctx, outer,
                                     x_shard=h if ctx.sp else None)
            else:
                y = mlp_forward(self.ffn, h_in, cfg, ctx, outer)
            x = x + (sp_scatter(y, ctx) if ctx.sp else y)
        return x, aux


def _superblock(blocks, x: torch.Tensor):
    """Run the layers of one superblock: (x, the sum of their aux losses
    or None), inside a ``model.block`` range (tracing on), which
    recompute opens again in backward."""
    aux = None
    with scope(BLOCK_SPAN):
        for blk in blocks:
            x, a = blk(x)
            if a is not None:
                aux = a if aux is None else aux + a
    return x, aux


class Transformer(nn.Module):
    """The model over a flat f32 parameter vector (see module doc): this
    model rank's shards under ``ctx``."""

    def __init__(self, cfg: ArchConfig, flat: torch.Tensor,
                 ctx: ParallelCtx = NO_TP):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        shapes = leaf_shapes(cfg, ctx.tp)
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
        self.layout = superblock_layout(cfg)
        blocks = []
        for sb in range(n_superblocks(cfg)):
            for i, (mx, ff) in enumerate(self.layout):
                lv = {p: v[sb] for p, v in
                      _sub(views, f"blocks.l{i}.").items()}
                blocks.append(Block(cfg, lv, mx, ff, ctx))
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Parameter(views["embed"]) if "embed" in views \
            else None
        self.norm_f = nn.Parameter(views["norm_f"])
        self.w_out = nn.Parameter(views["w_out"])
        self._flat = flat

    def superblocks(self) -> List[nn.ModuleList]:
        per = len(self.layout)
        return [self.blocks[i:i + per]
                for i in range(0, len(self.blocks), per)]

    def grad_order(self) -> List[nn.Parameter]:
        """Every parameter in the order backward completes its gradient:
        the reverse of the order ``loss_fn`` first uses them (a static
        order, the same on every rank: ``w_out`` first, ``embed`` last)."""
        fwd = [self.embed] if self.embed is not None else []
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
                        cfg: ArchConfig, ctx: ParallelCtx = NO_TP,
                        skip_gcopy: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over the vocab-parallel logits: the f32 logits of
    this rank's ``w_out`` columns, the padded vocab columns masked to
    -1e30, the row max taken over the model axis (outside autograd), the
    partition function and the label logit summed over it.  The logits
    themselves stay inside ``kernels.lm_head_xent``, which gives this
    rank's row max ``m_l``, sum of ``exp(logit - m_l)`` and label logit;
    the partition function is their rescaled sum.  Returns (mean loss,
    mean greedy accuracy) over ``mask``.  ``skip_gcopy``: x came through
    ``sp_gather``, whose backward already sums the partial cotangents."""
    xin = x if skip_gcopy else g_copy(x, ctx)
    v_l = w_out.shape[-1]
    m_l, s_l, ll = lm_head_xent(xin, w_out, labels, tp_rank(ctx) * v_l,
                                cfg.vocab)
    m = m_l
    if ctx.tp > 1:
        m = m_l.clone()
        count_collective("all_reduce", m, (MODEL_AXIS,), ctx.tp)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ctx.group)
    se = f_reduce(s_l * torch.exp(m_l - m), ctx)
    ll = f_reduce(ll, ctx)
    nll = torch.log(se) + m - ll
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    correct = ((ll.detach() - m).abs() < 1e-6) & (mask > 0)
    acc = correct.sum() / denom
    return loss, acc


def embed_tokens(embed: torch.Tensor, ids: torch.Tensor, ctx: ParallelCtx,
                 dtype, reduce: bool = True) -> torch.Tensor:
    """Vocab-parallel embedding lookup: this rank's rows hit, the others
    zero, summed over the model axis in f32 (``reduce=False``: this rank's
    partial, for ``sp_scatter`` to sum and split in one collective)."""
    if ctx.tp == 1:
        return F.embedding(ids.long(), embed).to(dtype)
    v_l = embed.shape[0]
    local = ids.long() - tp_rank(ctx) * v_l
    valid = (local >= 0) & (local < v_l)
    x = F.embedding(local.clamp(0, v_l - 1), embed)
    x = torch.where(valid[..., None], x, 0.0)
    if reduce:
        x = f_reduce(x, ctx)
    return x.to(dtype)


def _inputs_to_h0(embed: Optional[torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                  dtype, ctx: ParallelCtx = NO_TP) -> torch.Tensor:
    """The modality inputs as the first hidden states (B, S, d): token
    embeddings; the given frames (audio stub); or the patch prefix
    followed by the text's embeddings (VLM stub).  Under sequence
    parallelism, this rank's chunk of the sequence (B, S/tp, d): the
    partial vocab-parallel lookups are summed and split in one
    ``sp_scatter``, the replicated patches divided by tp first so the sum
    restores them (tp is a power of two)."""
    sp = ctx.sp and ctx.tp > 1
    if cfg.embed_kind == "embeddings":
        h = batch["embeddings"].to(dtype)
        return sp_slice(h, ctx) if sp else h
    txt = embed_tokens(embed, batch["tokens"], ctx, dtype, reduce=not sp)
    if cfg.embed_kind == "prefix":
        patch = batch["patch_embeds"]
        if sp:
            patch = patch.to(torch.float32) / ctx.tp
        txt = torch.cat([patch.to(dtype), txt], dim=1)
    return sp_scatter(txt, ctx) if sp else txt


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Training loss of this rank's batch: (total, {"loss", "aux",
    "acc"}), ``total = loss + aux_weight * aux`` with ``aux`` the MoE
    layers' load-balance losses summed (0 without experts, and then
    total == loss).  A ``prefix`` model's loss is over the text positions
    only.  Every model rank computes the same loss."""
    cfg, ctx = model.cfg, model.ctx
    sp = ctx.sp and ctx.tp > 1
    dtype = getattr(torch, cfg.compute_dtype)
    h = _inputs_to_h0(model.embed, batch, cfg, dtype, ctx)
    aux = None
    for sb in model.superblocks():
        fn = functools.partial(_superblock, sb)
        if not cfg.remat:
            h, a = fn(h)
        elif cfg.remat_policy == "dots":
            h, a = checkpoint(fn, h, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  save_dots))
        else:
            h, a = checkpoint(fn, h, use_reentrant=False)
        if a is not None:
            aux = a if aux is None else aux + a
    h = rms_norm(h, rep_param(model.norm_f, ctx), cfg.norm_eps)
    if sp:
        h = sp_gather(h, ctx)       # the LM head stays vocab-parallel
    labels = batch["labels"]
    if cfg.embed_kind == "prefix":
        h = h[:, -labels.shape[1]:, :]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss, acc = vocab_parallel_xent(h, model.w_out, labels, mask, cfg, ctx,
                                    skip_gcopy=sp)
    if aux is None:
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux": zero, "acc": acc}
    return loss + aux_weight * aux, {"loss": loss, "aux": aux, "acc": acc}


# --------------------------------------------------------------------------
# serving: prefill and KV-cached decode
# --------------------------------------------------------------------------

Params = Dict[str, torch.Tensor]


def _superblock_params(params: Params, cfg: ArchConfig
                       ) -> List[Dict[str, Dict[str, Any]]]:
    """Per-superblock views of the stacked block params: ``[{"l{i}":
    {"norm1", "norm2"?, "mixer": {...}, "ffn": {...}}}, ...]``."""
    out = []
    for sb in range(n_superblocks(cfg)):
        layers = {}
        for i in range(len(superblock_layout(cfg))):
            leaves = _sub(params, f"blocks.l{i}.")
            layer = {k: t[sb] for k, t in leaves.items() if "." not in k}
            for part in ("mixer", "ffn"):
                layer[part] = {k: t[sb] for k, t in
                               _sub(leaves, part + ".").items()}
            layers[f"l{i}"] = layer
        out.append(layers)
    return out


def _ffn(p, h: torch.Tensor, ffn: Optional[str], cfg: ArchConfig,
         ctx: ParallelCtx = NO_TP) -> torch.Tensor:
    """The residual FFN half of a serving layer (none for the SSM's)."""
    if ffn is None:
        return h
    hn = rms_norm(h, rep_param(p["norm2"], ctx), cfg.norm_eps)
    if ffn == "moe":
        return h + moe_forward(p["ffn"], hn, cfg, ctx)[0]
    return h + mlp_forward(p["ffn"], hn, cfg, ctx)


def check_serving(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is an arch that decodes (every family but the
    encoders)."""
    if cfg.family == "encoder":
        raise ValueError("encoder-only archs do not decode")


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_len: Optional[int] = None, ctx: ParallelCtx = NO_TP
            ) -> Tuple[torch.Tensor, Any]:
    """Prefill forward: last-position logits (B, V_l) in the compute dtype
    (V_l: this rank's shard of the padded vocab under ``ctx``, all of it
    at tp = 1) and the decode caches seeded from the sequence (this
    rank's kv heads and SSM channels; ``params`` are its shards).

    ``cache_len``: total KV-cache capacity (>= prompt length, the prefix
    included) so decode steps have slots to append into; a windowed arch
    whose prompt is longer than the window gets a ring buffer of the
    window instead, and the SSM state is fixed-size, as in the
    reference."""
    check_serving(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    h = _inputs_to_h0(params.get("embed"), batch, cfg, dtype, ctx)
    b, s = h.shape[:2]
    layout = superblock_layout(cfg)
    ring = bool(cfg.window) and s > cfg.window
    s_c = cfg.window if ring else max(s, cache_len or 0)
    caches = shard_caches(init_caches(cfg, b, s_c, dtype, "meta", tp=ctx.tp),
                          cache_specs(cfg, False), 1, ctx.tp, h.device)
    eps = cfg.norm_eps
    for sb, layers in enumerate(_superblock_params(params, cfg)):
        for i, (mx, ff) in enumerate(layout):
            p, c = layers[f"l{i}"], caches[f"l{i}"]
            hn = rms_norm(h, rep_param(p["norm1"], ctx), eps)
            if mx == "attn":
                y, (k, v) = attn_forward(p["mixer"], hn, cfg, return_kv=True,
                                         ctx=ctx)
                if ring:
                    w = cfg.window
                    slots = torch.arange(s - w, s, device=h.device) % w
                    c["k"][sb][:, slots] = k[:, s - w:]
                    c["v"][sb][:, slots] = v[:, s - w:]
                else:
                    c["k"][sb][:, :s] = k
                    c["v"][sb][:, :s] = v
            else:
                y, st = S.ssm_forward(p["mixer"], hn, cfg, return_state=True,
                                      ctx=ctx)
                c["h"][sb].copy_(st["h"])
                c["conv"][sb].copy_(st["conv"])
            h = _ffn(p, h + y, ff, cfg, ctx)
    return _head(params, h, cfg, ctx), caches


def _head(params: Params, h: torch.Tensor, cfg: ArchConfig,
          ctx: ParallelCtx) -> torch.Tensor:
    """The last position's logits of this rank's vocab shard, (B, V_l)."""
    h = rms_norm(h[:, -1, :], rep_param(params["norm_f"], ctx), cfg.norm_eps)
    return dense(g_copy(h, ctx), params["w_out"])


def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, device="cpu", seq_shards: int = 1,
                tp: int = 1) -> Any:
    """Zero decode caches in the reference's tree, each leaf stacked over
    the superblocks (global shapes at ``tp``; ``seq_shards`` as
    ``attention.init_kv_cache``)."""
    nsb = n_superblocks(cfg)
    out = {}
    for i, (mx, _) in enumerate(superblock_layout(cfg)):
        one = A.init_kv_cache(cfg, batch, seq_len, dtype, "meta",
                              seq_shards, tp) if mx == "attn" else \
            S.init_ssm_cache(cfg, batch, dtype, "meta", tp)
        out[f"l{i}"] = {k: torch.zeros((nsb,) + tuple(t.shape),
                                       dtype=t.dtype, device=device)
                        for k, t in one.items()}
    return out


def cache_specs(cfg: ArchConfig, seq_sharded: bool) -> Any:
    """Each cache leaf's (dp dim, model-axis dim) in the tree of
    :func:`init_caches` (None: replicated), as the reference's
    ``cache_specs``: over dp the batch (dim 1) of every leaf, or under
    ``seq_sharded`` the sequence (dim 2) of a full-attention KV cache,
    the windowed caches and the SSM state replicated; over the model axis
    the kv heads (dim 3), the SSM state's channels (``h`` dim 2) and the
    conv tail's channels (dim 3)."""
    out = {}
    for i, (mx, _) in enumerate(superblock_layout(cfg)):
        if mx == "attn":
            dim = (None if cfg.window else 2) if seq_sharded else 1
            out[f"l{i}"] = {"k": (dim, 3), "v": (dim, 3)}
        else:
            dim = None if seq_sharded else 1
            out[f"l{i}"] = {"h": (dim, 2), "conv": (dim, 3)}
    return out


def shard_caches(full: Any, specs: Any, n_dp: int, tp: int, device) -> Any:
    """Zero caches of one rank's slice of the global tree ``full`` (any
    device; only its shapes and dtypes are read): each leaf's dp dim
    divided by ``n_dp`` and its model dim by ``tp``, as ``specs``
    (:func:`cache_specs`) names them."""
    out = {}
    for name, leaves in full.items():
        out[name] = {}
        for k, t in leaves.items():
            shp = list(t.shape)
            for dim, n in zip(specs[name][k], (n_dp, tp)):
                if dim is not None:
                    if shp[dim] % n:
                        raise ValueError(f"cache {name}.{k} dim {dim} of "
                                         f"{shp[dim]} does not split over "
                                         f"{n} ranks")
                    shp[dim] //= n
            out[name][k] = torch.zeros(shp, dtype=t.dtype, device=device)
    return out


def decode_step(params: Params, batch: Dict[str, torch.Tensor], caches: Any,
                pos: int, cfg: ArchConfig,
                seq_group: Optional[A.SeqGroup] = None,
                ctx: ParallelCtx = NO_TP) -> Tuple[torch.Tensor, Any]:
    """One decode step: one new token per sequence against the caches.

    batch: {"tokens": (B, 1)} or {"embeddings": (B, 1, d)}; ``pos`` is the
    new token's absolute position; ``seq_group``: the ranks the
    full-attention KV caches are split over along the sequence (None: not
    split); ``ctx``: the model axis (``params`` and ``caches`` this rank's
    shards).  Updates ``caches`` in place and returns (logits (B, V_l),
    caches)."""
    check_serving(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.embed_kind == "embeddings":
        h = batch["embeddings"].to(dtype)
    else:
        h = embed_tokens(params["embed"], batch["tokens"], ctx, dtype)
    layout = superblock_layout(cfg)
    eps = cfg.norm_eps
    for sb, layers in enumerate(_superblock_params(params, cfg)):
        for i, (mx, ff) in enumerate(layout):
            p = layers[f"l{i}"]
            c = {k: t[sb] for k, t in caches[f"l{i}"].items()}
            hn = rms_norm(h, rep_param(p["norm1"], ctx), eps)
            if mx == "attn":
                y = A.decode_attn(p["mixer"], hn, c, pos, cfg, seq_group, ctx)
            else:
                y = S.decode_ssm(p["mixer"], hn, c, cfg, ctx)
            h = _ffn(p, h + y, ff, cfg, ctx)
    return _head(params, h, cfg, ctx), caches
