"""model.matmul_ms: device ms a step of the GEMM kernels launched from
the step's start to the end of its backward pass (the model's forward and
backward), NCCL kernels apart; the slowest rank."""
from portbench import readers


def read(run):
    return readers.kernel_ms(
        run, lambda k: k["part"] == "model" and k["gemm"])
