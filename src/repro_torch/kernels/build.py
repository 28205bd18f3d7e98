"""Build and load the port's hand-written Hopper kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), linked into ONE shared
library with a plain C interface, and loaded with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, keyed on a hash of the sources, the ``csrc/*.cuh`` headers they
include and the flags, so the first call
in a fresh checkout builds it and later calls on an unchanged tree reuse
it.  A failed build raises; nothing falls back to the plain versions.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.

Launch counts live here too: each kernel wrapper calls :func:`bump` once
per launch, so a run can show that its main path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry points: (argtypes, restype); every pointer and the stream is a
# void*, every length an int64 (d reaches 3.6e8 on the main path)
_SIGNATURES = {
    "repro_ef_compress": ((_P, _P, _P, _P, _P, _I64, _I64, _P), ctypes.c_int),
    "repro_decompress": ((_P, _P, _P, _I64, _I64, _P), ctypes.c_int),
    "repro_adam_step": ((_P, _P, _P, _P, _P, _P, _P, _I64, _F, _F, _F, _F,
                         _F, _F, _F, _P), ctypes.c_int),
    "repro_flash_attention": ((_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                               ctypes.c_int, ctypes.c_int, _I64, _P),
                              ctypes.c_int),
    "repro_flash_attention_wgmma": ((_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                     ctypes.c_int, ctypes.c_int, _I64, _P),
                                    ctypes.c_int),
    "repro_flash_attention_wide": ((_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                    ctypes.c_int, ctypes.c_int, _I64, _P),
                                   ctypes.c_int),
    "repro_lm_head_split": ((_P, _I64, _I64, _I64, _P, _I64, _I64,
                             ctypes.c_int, _P), ctypes.c_int),
    "repro_lm_head_xent_fwd": ((_P, ctypes.c_int, _I64, _I64, _I64, _P, _I64,
                                _I64, _I64, _I64, _P, _I64, _I64, _P, _P, _P,
                                _P), ctypes.c_int),
    "repro_lm_head_xent_dlogits": ((_P, ctypes.c_int, _I64, _I64, _I64, _P,
                                    _I64, _I64, _I64, _I64, _P, _I64, _P, _P,
                                    _P, _P, _I64, _I64, _I64, _P),
                                   ctypes.c_int),
    "repro_lm_head_xent_dx": ((_P, _I64, _I64, _I64, _I64, _P, _I64, _I64,
                               _I64, _P, _I64, ctypes.c_int, _I64, _P),
                              ctypes.c_int),
    "repro_lm_head_xent_dw": ((_P, ctypes.c_int, _I64, _I64, _I64, _I64, _P,
                               _I64, _I64, _I64, _P, _I64, ctypes.c_int, _I64,
                               _P), ctypes.c_int),
    "repro_moe_permute": ((_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P),
                          ctypes.c_int),
    "repro_moe_permute_bwd": ((_P, _P, _P, _I64, _I64, _I64, ctypes.c_int,
                               _P), ctypes.c_int),
    "repro_moe_combine": ((_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int,
                           _P), ctypes.c_int),
    "repro_moe_combine_bwd": ((_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                               ctypes.c_int, _P), ctypes.c_int),
    "repro_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}

_LAUNCHES: Dict[str, int] = {"ef_compress": 0, "decompress": 0,
                             "adam_step": 0, "flash_attention": 0,
                             "flash_attention_wgmma": 0,
                             "flash_attention_wide": 0,
                             "lm_head_xent_fwd": 0, "lm_head_xent_bwd": 0,
                             "moe_permute": 0, "moe_combine": 0}
_LIB: Optional[ctypes.CDLL] = None
_RECORDERS: List[List[Tuple[str, object]]] = []


def bump(name: str) -> None:
    """Count one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] += 1


def meta_launch(name: str, cost) -> None:
    """Hand a launch of kernel ``name`` that a wrapper's meta path (the dry
    run) stands in for, with its declared cost (a
    ``perf.kernel_cost.ComputeSpec``), to every recorder open
    (:func:`recording`).  Nothing is launched, so the launch counts
    (:func:`launch_counts`) do not move."""
    for rec in _RECORDERS:
        rec.append((name, cost))


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, object]]]:
    """A list that receives (kernel name, cost) of every meta launch made
    while the block runs."""
    rec: List[Tuple[str, object]] = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "port's kernels are built from csrc/ on a CUDA "
                           "machine")
    return found


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the hashed library path (if absent) and
    return it.  Safe against concurrent builders (a file lock)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        nvcc = _nvcc()
        objs = [out_dir / (src.stem + ".o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        tmp = out_dir / (LIB_NAME + ".tmp")
        _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, lib)
        if verbose:
            for log in logs:
                print(log.strip())
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every entry
    point's argtypes/restype declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = load().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
