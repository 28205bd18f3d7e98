"""kernels.ef_compress_roofline: the fused EF-compress kernel
(``csrc/onebit.cu`` ``ef_compress_kernel``) against its bound, each
launch at the length the optimizer hands it.

The cost is a frozen copy of ``src/repro_torch/perf/kernel_cost.py``
``ef_compress_cost`` at commit 17de659: it reads x and err and writes
new_err (12 d bytes), the d / 8 packed bytes and one float32 scale a
block; 4 d float32 operations."""
from portbench import readers

WRAPPER = ("repro_torch.kernels.onebit.kernel", "ef_compress_fused")
DEVICE_KERNEL = "ef_compress_kernel"
NAME = "kernels.ef_compress_roofline"


def call_size(x, err, block_size=4096, out=None):
    return {"d": int(x.shape[0]), "block": int(block_size)}


def cost(d, block):
    """(operations, bytes) of one launch."""
    return 4.0 * d, 3 * 4 * d + d // 8 + 4 * (d // block)


def read(run):
    return readers.roofline(run, NAME, cost)
