"""The compressed-optimizer family (slice 1: 1-bit Adam) and its pieces."""
from repro_torch.optim.base import (STAT_KEYS, TwoStageOptimizer,
                                    get_optimizer, list_optimizers,
                                    register_optimizer)
from repro_torch.optim.compressors import (Compressor, IdentityCompressor,
                                           OneBitCompressor, get_compressor,
                                           list_compressors)
from repro_torch.optim.onebit_adam import OneBitAdam
from repro_torch.optim.switch import WarmupSwitch

__all__ = ["STAT_KEYS", "TwoStageOptimizer", "get_optimizer",
           "list_optimizers", "register_optimizer", "Compressor",
           "IdentityCompressor", "OneBitCompressor", "get_compressor",
           "list_compressors", "OneBitAdam", "WarmupSwitch"]
