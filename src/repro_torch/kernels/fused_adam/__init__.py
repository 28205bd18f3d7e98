"""Fused BertAdam update: Hopper kernel (CUDA tensors), plain version (CPU)."""
