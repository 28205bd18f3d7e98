"""musicgen-large — decoder-only transformer over EnCodec audio tokens.
The EnCodec conv frontend is STUBBED: the batch carries precomputed
frame embeddings (B, S, d); this config is the language/decoder backbone.
[arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, embed_kind="embeddings",
    source="arXiv:2306.05284",
))
