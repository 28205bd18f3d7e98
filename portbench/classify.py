"""Device-kernel name classes.

Frozen copy of the name rules of ``chip_smoke.py`` ``_kernel_group`` and
``tests/_torch_tp_worker.py`` ``_matmul_nccl_ms`` at commit 17de659: a
cuBLAS / CUTLASS matrix product by its name's ``gemm``, ``xmma``,
``cutlass``, ``sm90_`` or ``nvjet``, an NCCL kernel by ``nccl``.
"""
from __future__ import annotations

GEMM_KEYS = ("gemm", "xmma", "cutlass", "sm90_", "nvjet")


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_nccl(name) and any(k in low for k in GEMM_KEYS)
