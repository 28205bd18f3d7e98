"""setup_s: process start to the window's start: CUDA, the kernel library
(built by the first run in a checkout), the weights, the batch pool, the
set-up steps."""


def read(run):
    return run["setup_s"]
