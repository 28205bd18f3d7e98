"""Flash-attention forward: Hopper kernels (``csrc/flash_attn_sm90.cu`` for
bf16/fp16 on the tensor cores, ``csrc/flash_attn.cu`` for f32) and their
plain PyTorch version."""
