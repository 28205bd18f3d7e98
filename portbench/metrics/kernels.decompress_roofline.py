"""kernels.decompress_roofline: the decompress kernel (``csrc/onebit.cu``
``decompress_kernel``) against its bound, each launch at its own length.

The cost is a frozen copy of ``src/repro_torch/perf/kernel_cost.py``
``decompress_cost`` at commit 17de659: it reads the d / 8 packed bytes
and one float32 scale a block and writes d float32 values; 2 d
operations."""
from portbench import readers

WRAPPER = ("repro_torch.kernels.onebit.kernel", "decompress")
DEVICE_KERNEL = "decompress_kernel"
NAME = "kernels.decompress_roofline"


def call_size(packed, scales, block_size=4096, out=None):
    return {"d": int(packed.shape[0]) * 8, "block": int(block_size)}


def cost(d, block):
    """(operations, bytes) of one launch."""
    return 2.0 * d, 4 * d + d // 8 + 4 * (d // block)


def read(run):
    return readers.roofline(run, NAME, cost)
