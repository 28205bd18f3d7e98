"""granite-34b — deep llama-arch code model with MQA (1 kv head).
[arXiv:2405.04324]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    source="arXiv:2405.04324",
))
