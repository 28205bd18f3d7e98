"""moe.dispatch_ms: device ms a step of the dropless expert layer's
dispatch kernels (``csrc/moe_dispatch.cu``: the kernels whose names hold
``moe_permute`` or ``moe_combine``, forward, recompute and backward);
the slowest rank."""
from portbench import readers


def read(run):
    return readers.kernel_ms(
        run, lambda k: "moe_permute" in k["name"]
        or "moe_combine" in k["name"])
