"""Hand-written Hopper kernels of the port, each beside its plain version.

``onebit``        EF 1-bit compress and decompress (``csrc/onebit.cu``)
``fused_adam``    fused BertAdam update (``csrc/fused_adam.cu``)
``flash_attn``    flash-attention forward (``csrc/flash_attn_sm90*.cu``)
``lm_head_xent``  the LM head and its cross-entropy (``csrc/lm_head_xent.cu``)
``build``         builds ``csrc/*.cu`` into one ctypes library; launch counts
"""
