"""1-bit EF compression: Hopper kernel (CUDA tensors), plain version (CPU)."""
