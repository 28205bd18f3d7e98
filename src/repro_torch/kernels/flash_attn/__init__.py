"""Flash-attention forward: Hopper kernel (``csrc/flash_attn.cu``) and its
plain PyTorch version."""
