"""Flash-attention forward: Hopper tensor-core kernels
(``csrc/flash_attn_sm90.cu`` for bf16/fp16 up to D = 256,
``csrc/flash_attn_sm90_split.cu`` for f32 and for every dtype above) and
their plain PyTorch version."""
