"""The LM head and its cross-entropy: Hopper kernels (CUDA tensors), plain
version (CPU)."""
