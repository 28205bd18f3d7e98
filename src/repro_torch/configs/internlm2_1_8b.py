"""internlm2-1.8b — dense GQA decoder. [arXiv:2403.17297]

The reference's config, field for field: the model of the convergence
benchmark and the quickstart (at its ``-smoke`` reduction)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
))
