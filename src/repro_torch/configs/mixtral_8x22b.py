"""mixtral-8x22b — MoE decoder, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, window=4096, rope_theta=1_000_000.0,
    n_experts=8, moe_top_k=2,
    source="arXiv:2401.04088",
))
