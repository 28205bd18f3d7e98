"""optim.device_ms: device ms a step of the kernels launched after the
backward pass ends (the optimizer's update and its exchange's compress
and decompress), NCCL kernels apart; the slowest rank."""
from portbench import readers


def read(run):
    return readers.kernel_ms(
        run, lambda k: k["part"] == "optimizer" and not k["nccl"])
