"""llama3.2-3b — small Llama-3 dense decoder with GQA.
[hf:meta-llama/Llama-3.2-1B family card; dims per assignment]

The serving slice's model: 28 layers, d 3072, 24 query / 8 kv heads of
dim 128, SwiGLU d_ff 8192, vocab 128,256, rope theta 5e5, no window.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
))
