"""The compressed-optimizer family (1-bit Adam, 0/1 Adam, 1-bit LAMB) and
its pieces."""
from repro_torch.optim.base import (LAYOUTS, STAT_KEYS, SegmentInfo,
                                    TwoStageOptimizer, get_optimizer,
                                    list_optimizers, register_optimizer,
                                    segment_l1, segment_norms, segments_of)
from repro_torch.optim.compressors import (Compressor, IdentityCompressor,
                                           OneBitCompressor, TopKCompressor,
                                           as_compressor,
                                           compressor_has_kernel,
                                           get_compressor, list_compressors)
from repro_torch.optim.onebit_adam import OneBitAdam
from repro_torch.optim.onebit_lamb import OneBitLamb
from repro_torch.optim.switch import WarmupSwitch
from repro_torch.optim.zerone_adam import ZeroneAdam

__all__ = ["LAYOUTS", "STAT_KEYS", "SegmentInfo", "TwoStageOptimizer",
           "get_optimizer", "list_optimizers", "register_optimizer",
           "segment_l1", "segment_norms", "segments_of", "Compressor",
           "IdentityCompressor", "OneBitCompressor", "TopKCompressor",
           "as_compressor", "compressor_has_kernel", "get_compressor",
           "list_compressors", "OneBitAdam", "OneBitLamb", "WarmupSwitch",
           "ZeroneAdam"]
