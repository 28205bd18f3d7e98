"""kernels.moe_permute_roofline: the dispatch permute kernels
(``csrc/moe_dispatch.cu`` ``moe_permute_fwd_kernel`` and
``moe_permute_bwd_kernel``) against their bound, each launch at its true
row count, read from the launch's index on the device (a sync in the
traced steps only, outside the measured window).

The cost is a frozen copy of ``src/repro_torch/perf/kernel_cost.py``
``moe_permute_cost``: the forward reads the T k pair indices and each
routed token's row once and writes the filled rows; the backward reads
the T k slots and the filled rows and writes T rows, one add an element
of a filled row."""
from portbench import readers

WRAPPER = ("repro_torch.kernels.moe_dispatch.kernel", "moe_permute")
DEVICE_KERNEL = "moe_permute"
NAME = "kernels.moe_permute_roofline"


def call_size(src, index, k, backward=False):
    import torch
    live = index >= 0
    if backward:            # index: slot (T, k)
        t, filled = index.shape[0], int(live.sum())
        tokens = int(live.any(dim=1).sum())
    else:                   # index: pair (T k,)
        t, filled = index.shape[0] // k, int(live.sum())
        tokens = int(torch.unique(index[live] // k).numel())
    return {"backward": bool(backward), "t": t, "k": int(k),
            "d": int(src.shape[1]), "itemsize": src.element_size(),
            "filled": filled, "tokens": tokens}


def cost(backward, t, k, d, itemsize, filled, tokens):
    """(operations, bytes) of one launch."""
    if not backward:
        return 0.0, 4 * t * k + (tokens + filled) * d * itemsize
    return float(filled * d), 4 * t * k + (filled + t) * d * itemsize


def read(run):
    return readers.roofline(run, NAME, cost)
