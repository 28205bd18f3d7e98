"""kernels.adam_step_roofline: the fused BertAdam kernel
(``csrc/fused_adam.cu`` ``adam_kernel``) against its bound, each launch
at the (tile-padded) length the optimizer hands it.

The cost is a frozen copy of ``src/repro_torch/perf/kernel_cost.py``
``adam_update_cost(fused=True)`` at commit 17de659: 4 reads (x, m, v, g)
and 3 writes (x, m, v) of d float32 values, 28 d bytes; 12 d
operations."""
from portbench import readers

WRAPPER = ("repro_torch.kernels.fused_adam.kernel", "adam_step")
DEVICE_KERNEL = "adam_kernel"
NAME = "kernels.adam_step_roofline"


def call_size(x, *args, **kwargs):
    return {"d": int(x.shape[0])}


def cost(d):
    """(operations, bytes) of one launch."""
    return 12.0 * d, 28 * d


def read(run):
    return readers.roofline(run, NAME, cost)
