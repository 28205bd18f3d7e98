"""moonlight-16b-a3b — DeepSeek-V3's block at 16 B: multi-head latent
attention, one leading dense layer, then 26 layers of a sigmoid-routed,
dropless 64-expert top-6 MoE with two shared experts.
[https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json;
the layer equations arXiv:2412.19437]

No ``q_lora_rank`` (q is one projection), no YaRN, no multi-token
prediction and one expert group, as the config states.  Rope acts on the
64 rope dims of each q head and on the one k_pe head in the half-split
convention of ``models.common.apply_rope``; the published interleaved
layout equals it up to a fixed permutation of those columns of ``wq`` and
``wkva``.

``moonlight-16b-a3b-ep8`` is the same architecture as one chip of an
expert-parallel deployment over 8 chips: it holds experts 0-7 of each MoE
layer's 64 (the router keeps all 64 outputs and its top 6) and computes
those experts' part of the layer.  The benchmark's cell cuts its depth
and vocabulary further (``portbench/configs/moonlight-16b-a3b.json``).
The reference package has neither."""
import dataclasses

from repro_torch.configs.base import ArchConfig, register

SOURCE = "https://huggingface.co/moonshotai/Moonlight-16B-A3B"

CONFIG = register(ArchConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840, rope_theta=50_000.0, norm_eps=1e-5,
    n_experts=64, moe_top_k=6, moe_kind="dropless", moe_d_ff=1408,
    n_shared_experts=2, moe_gate_scale=2.446, n_dense_lead=1,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    source=SOURCE,
))

EP8 = register(dataclasses.replace(
    CONFIG, name="moonlight-16b-a3b-ep8", experts_held=8, expert_first=0))
