"""comm.nccl_ms: device ms a step of the NCCL kernels (the dp exchange
and the tensor-parallel collectives), on the slowest rank."""
from portbench import readers


def read(run):
    return readers.kernel_ms(run, lambda k: k["nccl"])
