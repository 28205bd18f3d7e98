"""Emit the slot-layout manifest JSON (CI artifact).

The port of ``benchmarks/state_manifest.py``, the state analogue of
``comm_volume --check-plans``: for a canonical grid of (layout x
topology) points this writes, deterministically, the declared slot table
(extent/replication/dtype/EF role), the materialised per-rank lengths and
state bytes, and a checksum of the run->canonical EF permutation per
pipeline bucket count.  Built from the port's own slot registry, its
text equals the reference's for the default grid, so a drift of either
side's state layout shows up in the artifact diff.  ``--tp T`` describes
each model rank's state on a model axis of T (the ``tp`` of every
context; the per-rank lengths are a model rank's).

  python -m repro_torch.benchmarks.state_manifest --json slot_layout.json
"""
from __future__ import annotations

import argparse

from repro_torch.optim import LAYOUTS, TwoStageOptimizer
from repro_torch.state import StateLayout, layout_manifest, manifest_json

D = 1 << 20
N_INNER, N_OUTER = 4, 2
BLOCK = 4096


def build_manifest(d: int = D, n_inner: int = N_INNER,
                   n_outer: int = N_OUTER, block: int = BLOCK,
                   tp: int = 1) -> dict:
    opt = TwoStageOptimizer()
    n_dp = n_inner * n_outer
    out = {"d": d, "block": block, "grid": {}}
    for layout in LAYOUTS:
        for topo in ("flat", "hier"):
            n_srv = n_inner if topo == "hier" else n_dp
            ctx = StateLayout(
                d=d, n_dp=n_dp, n_srv=n_srv,
                n_outer=n_outer if topo == "hier" else 1,
                n_segments=8,
                dp_sizes=(n_outer, n_inner), tp=tp)
            out["grid"][f"{layout}/{topo}"] = layout_manifest(
                opt.state_slots(layout), ctx, block=block)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tp", type=int, default=1,
                    help="the model axis of the described mesh")
    ap.add_argument("--json", default=None,
                    help="write the manifest JSON here")
    args = ap.parse_args(argv)
    man = build_manifest(tp=args.tp)
    text = manifest_json(man)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.json}")
    else:
        print(text)
    return man


if __name__ == "__main__":
    main()
