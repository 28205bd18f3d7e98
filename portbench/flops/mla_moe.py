"""Model FLOPs of one training step of the DeepSeek-V3 block
(``reference/mla_moe.py``): MLA, the leading dense layers, the dropless
expert layers with shared experts, the LM head over the configuration's
vocabulary.

Convention (PaLM, arXiv:2204.02311, appendix B): 6 FLOPs per token for
every parameter that enters a matrix product a token goes through, plus
the attention products.  A token goes through each layer's MLA
projections (wq, wkva, wkvb, wo), the dense layers' SwiGLU, each expert
layer's router and shared experts, and the held experts at the expected
share of a uniform router: k * held / E of an expert's SwiGLU a token
(the rows the chip's experts see); the LM head's d x vocab.  The
attention products are 6 * heads * (qk + v) * seq a token and layer (QK^T
over the nope + rope dims and PV over the v dims, forward and backward);
a causal mask does not halve them (the program computes the whole masked
square).  Recompute is not counted; the embedding lookup and the norm
scales are not products.
"""
from __future__ import annotations


def matmul_params(cfg: dict) -> float:
    """Parameters a token's matrix products go through (the held experts
    at their expected share)."""
    d, h = cfg["d_model"], cfg["n_heads"]
    r, nope, rope, vd = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) \
        + h * vd * d
    lead = cfg["first_k_dense_replace"]
    n_moe = cfg["n_layers"] - lead
    f, e, k = cfg["moe_intermediate_size"], cfg["n_routed_experts"], \
        cfg["num_experts_per_tok"]
    moe = d * e + 3 * d * f * cfg["n_shared_experts"] \
        + 3 * d * f * k * cfg["experts_held"] / e
    return (cfg["n_layers"] * mla + lead * 3 * d * cfg["d_ff"]
            + n_moe * moe + d * cfg["vocab"])


def step_flops(cfg: dict, tokens: int, seq: int) -> float:
    """FLOPs of a step over ``tokens`` tokens in sequences of ``seq``."""
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = 6 * cfg["n_heads"] * (qk + cfg["v_head_dim"]) * seq
    return float(6 * matmul_params(cfg) * tokens
                 + cfg["n_layers"] * attn * tokens)
