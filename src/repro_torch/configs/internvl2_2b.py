"""internvl2-2b — InternViT + InternLM2 VLM. The vision encoder +
projector are STUBBED: the batch carries 256 precomputed patch
embeddings per sample; this config is the InternLM2 language backbone
consuming [patch prefix | text tokens]. [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, embed_kind="prefix", n_prefix=256,
    source="arXiv:2404.16821",
))
