"""kernels.moe_combine_roofline: the dispatch combine kernels
(``csrc/moe_dispatch.cu`` ``moe_combine_fwd_kernel`` and
``moe_combine_bwd_kernel``) against their bound, each launch at its true
row count, read from the launch's index on the device (a sync in the
traced steps only, outside the measured window).

The cost is a frozen copy of ``src/repro_torch/perf/kernel_cost.py``
``moe_combine_cost``: the forward reads the T k slots and gates and the
filled rows and writes T rows, a multiply and an add an element of a
filled row; the backward reads the T k pair indices, the filled pairs'
gates, the routed tokens' cotangent rows and the filled rows, and
writes the filled rows' cotangents and their gates' (a multiply, and a
multiply and an add, an element of a filled row)."""
from portbench import readers

WRAPPER = ("repro_torch.kernels.moe_dispatch.kernel", "moe_combine")
DEVICE_KERNEL = "moe_combine"
NAME = "kernels.moe_combine_roofline"


def call_size(ye, g, index, k, dy=None):
    import torch
    live = index >= 0
    t = g.shape[0]
    filled = int(live.sum())
    if dy is None:          # index: slot (T, k)
        tokens = int(live.any(dim=1).sum())
    else:                   # index: pair (T k,)
        tokens = int(torch.unique(index[live] // k).numel())
    return {"backward": dy is not None, "t": t, "k": int(k),
            "d": int(ye.shape[1]), "itemsize": ye.element_size(),
            "filled": filled, "tokens": tokens}


def cost(backward, t, k, d, itemsize, filled, tokens):
    """(operations, bytes) of one launch."""
    if not backward:
        return 2.0 * filled * d, 8 * t * k + (filled + t) * d * itemsize
    return 3.0 * filled * d, 4 * t * k + 8 * filled \
        + (tokens + 2 * filled) * d * itemsize


def read(run):
    return readers.roofline(run, NAME, cost)
