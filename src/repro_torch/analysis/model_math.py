"""Analytic model FLOPs (the 6·N·D yardstick) per (arch, input shape).

Conventions, as the reference's ``analysis/model_math.py``:
  N        = active parameters EXCLUDING the input embedding table
             (lookups are gathers, not matmuls); the unembedding matmul is
             counted through its parameters.
  train    : 6 * N * tokens   (fwd 2ND + bwd 4ND)
  prefill  : 2 * N * tokens
  decode   : 2 * N * batch    (one token a sequence); KV-cache reads are
             memory traffic, not matmul FLOPs.
  attention scores (train/prefill): 12 * L_attn * H * hd * S^2 * B / 2
             causal fwd+bwd, reported apart as ``attn_flops``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape


def _embed_params(cfg: ArchConfig, tp: int = 1) -> int:
    if cfg.embed_kind in ("tokens", "prefix"):
        return cfg.padded_vocab(tp) * cfg.d_model
    return 0


def active_params_no_embed(cfg: ArchConfig, tp: int = 1) -> int:
    return cfg.active_param_count(tp) - _embed_params(cfg, tp)


def param_count_local(cfg: ArchConfig, tp: int = 1) -> int:
    """Exact per-model-rank parameter count: the summed sizes of this
    rank's shards of the ``init_params`` leaves at ``tp`` (the flat
    optimizer vector before padding)."""
    from repro_torch.models.transformer import flat_size
    return int(flat_size(cfg, tp))


def param_bytes(cfg: ArchConfig, tp: int = 1, dtype_bytes: int = 4) -> int:
    """Per-model-rank parameter bytes (see :func:`param_count_local`)."""
    return param_count_local(cfg, tp) * int(dtype_bytes)


def activation_bytes(cfg: ArchConfig, batch_local: int, seq: int,
                     tp: int = 1, dtype_bytes: int = 4) -> float:
    """Estimated per-rank live-set bytes of one fwd+bwd step without
    recomputation: per token and layer the residual stream and its norm,
    the attention projections, the MLP pair and the score and softmax
    maps (quadratic in ``seq``); plus the embedding output and the
    logits."""
    t = max(int(batch_local), 1) * max(int(seq), 1)
    d = cfg.d_model
    ff_local = cfg.d_ff // max(tp, 1)
    hq = cfg.padded_heads(tp) if cfg.n_heads else 0
    per_layer = 4 * d + 2 * ff_local + 2 * hq * seq
    vocab = cfg.padded_vocab(tp) if cfg.embed_kind == "tokens" else 0
    total = t * (cfg.n_layers * per_layer + 2 * d + 2 * vocab)
    return float(dtype_bytes) * total


def layer_bwd_flops(cfg: ArchConfig, shape: InputShape, tp: int = 1
                    ) -> list:
    """Per-layer backward FLOPs of one train step, layer 0 first: the
    4ND backward share of 6ND spread evenly over the layers, plus each
    attention layer's backward score FLOPs (8 of the 12 in
    :func:`model_flops`'s causal convention)."""
    n = active_params_no_embed(cfg, tp)
    b, s = shape.global_batch, shape.seq_len
    layers = max(cfg.n_layers, 1)
    per_layer_core = 4.0 * n * b * s / layers
    hq = cfg.padded_heads(tp)
    hd = cfg.head_dim
    out = []
    for i in range(layers):
        fl = per_layer_core
        if hq and cfg.is_attn_layer(i):
            fl += 8.0 * b * (s ** 2) / 2 * hq * hd
        out.append(fl)
    return out


def bwd_ready_times(offsets, d: int, cfg: ArchConfig, shape: InputShape,
                    device, tp: int = 1) -> list:
    """Seconds (on ``device``, a DeviceSpec) until the gradient element at
    each flat offset is produced by the backward sweep.

    Computed as the reference does: ravel order is taken as layer order
    (layer 0 first) while backward runs last to first, so the element at
    offset ``x`` exists once the sweep has spent the backward FLOPs of
    every layer above ``x`` (linear within a layer's span).  At a
    bucket's lowest offset this is the bucket's ready time.  The port's
    flat vector stacks every layer of a leaf, and backward overlap issues
    buckets by ``Transformer.grad_order``, so this is the priced overlap,
    not the executed one.  ``ready[0]`` is the whole backward time."""
    flops = layer_bwd_flops(cfg, shape, tp)
    layers = len(flops)
    peak = float(device.peak_flops)
    d = max(int(d), 1)
    span = d / layers
    suffix = [0.0] * (layers + 1)
    for i in range(layers - 1, -1, -1):
        suffix[i] = suffix[i + 1] + flops[i]
    out = []
    for off in offsets:
        x = min(max(float(off), 0.0), float(d))
        i = min(int(x / span), layers - 1)
        frac = min(max((x - i * span) / span, 0.0), 1.0)
        produced = suffix[i + 1] + flops[i] * (1.0 - frac)
        out.append(produced / peak)
    return out


def bwd_total_time(cfg: ArchConfig, shape: InputShape, device,
                   tp: int = 1) -> float:
    """Roofline seconds of the whole backward pass on ``device``."""
    return sum(layer_bwd_flops(cfg, shape, tp)) / float(device.peak_flops)


def model_flops(cfg: ArchConfig, shape: InputShape, tp: int = 1
                ) -> Dict[str, float]:
    n = active_params_no_embed(cfg, tp)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        core = 6.0 * n * b * s
    elif shape.kind == "prefill":
        core = 2.0 * n * b * s
    else:  # decode: one token a sequence
        core = 2.0 * n * b
    # attention score/value matmul FLOPs (not in 6ND)
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    hq = cfg.padded_heads(tp)
    hd = cfg.head_dim
    if n_attn and hq:
        if shape.kind == "train":
            # S^2/2 scores; qk^T + att*v = 4*hd flops a score pair forward,
            # x3 with backward
            attn = 12.0 * n_attn * b * (s ** 2) / 2 * hq * hd
        elif shape.kind == "prefill":
            attn = 4.0 * n_attn * b * (s ** 2) / 2 * hq * hd
        else:
            ctx_len = min(s, cfg.window) if cfg.window else s
            attn = 4.0 * n_attn * b * ctx_len * hq * hd
    else:
        attn = 0.0
    return {"model_flops": core, "attn_flops": attn,
            "n_active_no_embed": float(n)}
