"""falcon-mamba-7b — attention-free Mamba-1 SSM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, ssm_state=16,
    source="arXiv:2410.05355",
))
