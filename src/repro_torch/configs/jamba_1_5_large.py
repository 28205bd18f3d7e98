"""jamba-1.5-large-398b — hybrid Mamba+attention (1 attn per 8 layers),
MoE 16 experts top-2 on every second layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, ssm_state=16,
    n_experts=16, moe_top_k=2, moe_every=2, attn_every=8,
    source="arXiv:2403.19887",
))
