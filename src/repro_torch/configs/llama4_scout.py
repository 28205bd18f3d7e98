"""llama4-scout-17b-a16e — MoE decoder, 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, rope_theta=500_000.0,
    n_experts=16, moe_top_k=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
