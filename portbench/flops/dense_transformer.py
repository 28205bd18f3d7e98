"""Model FLOPs of one training step of a dense pre-norm transformer.

Convention (PaLM, arXiv:2204.02311, appendix B): 6 FLOPs per token for
every parameter that enters a matrix product (the q, k, v, o and MLP
projections of each layer, and the LM head at the published vocabulary;
the embedding lookup and the norm scales excluded), plus the attention
products 12 * layers * d_attn * seq per token (QK^T and PV, forward and
backward, d_attn = heads * head_dim).  A causal mask does not halve the
attention term: the program computes the whole masked square.  Recompute
is not counted.
"""
from __future__ import annotations


def matmul_params(cfg: dict) -> int:
    d, ff, L = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    hd = d // cfg["n_heads"]
    q = cfg["n_heads"] * hd
    kv = cfg["n_kv_heads"] * hd
    mlp = (3 if cfg["mlp_kind"] == "swiglu" else 2) * d * ff
    return L * (2 * d * q + 2 * d * kv + mlp) + d * cfg["vocab"]


def step_flops(cfg: dict, tokens: int, seq: int) -> float:
    """FLOPs of a step over ``tokens`` tokens in sequences of ``seq``."""
    d_attn = cfg["n_heads"] * (cfg["d_model"] // cfg["n_heads"])
    return float(6 * matmul_params(cfg) * tokens
                 + 12 * cfg["n_layers"] * d_attn * seq * tokens)
