"""bert-large — the paper's own pre-training target (Devlin et al. 2019):
L=24, H=1024, A=16, 340M params, MLM objective, encoder-only.

Deviations from the original, as in the reference: rotary instead of
learned absolute positions, RMSNorm instead of LayerNorm — neither affects
the optimizer/communication behaviour the paper studies.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="bert-large", family="encoder",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=30522, causal=False, mlp_kind="gelu",
    source="Devlin et al. 2019 / paper Sec. 7.1",
))

BERT_BASE = register(ArchConfig(
    name="bert-base", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=30522, causal=False, mlp_kind="gelu",
    source="Devlin et al. 2019 / paper Sec. 7.1",
))
