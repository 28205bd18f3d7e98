"""model.other_ms: device ms a step of every other kernel of the model's
part of the step (elementwise, reductions, softmax, copies), NCCL kernels
apart; the slowest rank."""
from portbench import readers


def read(run):
    return readers.kernel_ms(
        run, lambda k: k["part"] == "model" and not k["gemm"]
        and not k["nccl"])
