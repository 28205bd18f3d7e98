"""Core of the port: 1-bit compression, the compressed collectives, the
variance monitor, and the functional 1-bit Adam oracles (Algorithm 1 as
plain functions on flat vectors)."""
from repro_torch.core.compression import (CompressionConfig, compress_onebit,
                                          decompress_onebit, ef_compress,
                                          pack_signs, padded_length,
                                          unpack_signs, wire_bytes)
from repro_torch.core.comm import allreduce_mean, compressed_allreduce
from repro_torch.core.adam import AdamConfig, AdamState
from repro_torch.core.adam import init as adam_init
from repro_torch.core.adam import update as adam_update
from repro_torch.core.onebit_adam import (OneBitAdamConfig, OneBitAdamState,
                                          compressed_update, warmup_update)
from repro_torch.core.onebit_adam import init as onebit_adam_init
from repro_torch.core.variance import VarianceMonitor

__all__ = ["CompressionConfig", "compress_onebit", "decompress_onebit",
           "ef_compress", "pack_signs", "padded_length", "unpack_signs",
           "wire_bytes", "allreduce_mean", "compressed_allreduce",
           "AdamConfig", "AdamState", "adam_init", "adam_update",
           "OneBitAdamConfig", "OneBitAdamState", "compressed_update",
           "warmup_update", "onebit_adam_init", "VarianceMonitor"]
