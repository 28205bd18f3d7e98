"""Root pytest hook: cap torch's intra-op threads in each xdist worker.

Under ``pytest -n N`` every worker is its own process, and torch's default
intra-op pool takes every core in each of them, so N workers run N x cores
threads on cores cores.  Each worker gets ``cores // N`` threads (at least
one) instead.  A run without xdist keeps torch's default.
"""
import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
