"""The readings the comparison's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload bert-large.onebit.b128s128 \\
        --seeds 11,12,13 [--out chiprun_out/cal.jsonl]

For each seed, one JSON line: the numbers of ``check`` for the program
(``sound``), for the control (the reference with its state in bfloat16,
one precision step below the configured float32, against the reference),
and for each fault planted under the program's step (``half_batch``, and
on more than one dp rank ``no_exchange``; a state left unchanged reads 1
by construction).  On the card only; the benchmark's own runs never run
this.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from portbench import harness
    cell = harness.load_cell(args.workload)
    job = {"mode": "calibrate", "cell": cell, "device": "cuda",
           "seeds": [int(s) for s in args.seeds.split(",")]}
    rows = harness.run_job(job)["rows"]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(dict(row, cell=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
