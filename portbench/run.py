"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload bert-large.onebit.b128s128 \\
        --seed 1234 --seconds 30 --trace 0

Runs on the machine it is started on, one process a card; exits 2, with
no result, without CUDA or with fewer cards than the cell asks for.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``; ``checks`` last, each compared number beside its
limit), and the last lines of standard error repeat the compared numbers.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache of the program at a fixed place in the
    checkout (the kernel library builds into ``build/repro_torch_kernels``
    of its own)."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    _caches()
    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    job = {"mode": "bench", "cell": cell, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "device": "cuda"}
    rec = harness.run_job(job)
    bad = sorted(set(harness.forbidden_modules())
                 | {m for r in rec["ranks"] for m in r["forbidden"]})
    if bad:
        print(f"portbench: modules of the JAX package or JAX loaded: {bad}",
              file=sys.stderr)
        return 3
    out = harness.result(cell, job, rec, T_START)
    marks = rec["ranks"][0]["marks"]
    print("set-up, rank 0: " + ", ".join(
        f"{name} {t1 - t0:.2f} s" for (_, t0), (name, t1)
        in zip([("process start", T_START)] + marks[:-1], marks))
        + f"; of which the check's readings "
        f"{rec['ranks'][0]['check_s']:.2f} s; the reference's steps "
        + ", ".join(f"{t:.2f}" for t in rec["ranks"][0]["ref_steps_s"])
        + " s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
