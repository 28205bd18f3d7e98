"""The reference's ``remat_policy="dots"`` experiments through the port's
dry run, each beside its partner with whole-block recompute.

``results/hillclimb.py`` runs four ``"dots"`` experiments on
mixtral-8x22b and granite-34b at train_4k through ``lower_one(
cfg_overrides=...)``: B1, B3, A4 and B5.  This script traces each of them
and its partner under ``"block"`` (B1 against the baseline B0, B3 against
B2, A4 against A2, B5 against B5 with ``"block"``; B0 and A2 also with
no recompute; and chip_smoke.py's BERT-Large main path on one card under
each policy) as rank 0 of the same mesh, and prints for each the traced FLOPs of the products without batch
dimensions (``aten.mm`` / ``aten.addmm``) and of the batched ones
(``aten.bmm``), the total dot FLOPs, the traced peak bytes, and the
roofline terms priced on the h100-sxm data sheet.  ``--layers N`` cuts
``n_layers`` to N for both partners alike.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        [--only B1,B0] [--layers N] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import lower_one

_MIX = dict(arch="mixtral-8x22b", shape_name="train_4k")
# the reference's ((32, 8), ("data", "model")) mesh
_GRAN = dict(arch="granite-34b", shape_name="train_4k", mesh_override="32x8")
# the reference's experiments and the partners this script adds: B1
# beside B0, B3 beside B2, A4 beside A2, B5 dots beside B5 block; B0 and
# A2 also with no recompute (the products "dots" keeps run once there)
EXPS = {
    "B0_block": dict(_MIX, cfg_overrides={"remat_policy": "block"}),
    "B1_remat_dots": dict(_MIX, cfg_overrides={"remat_policy": "dots"}),
    "B2_cap10": dict(_MIX, cfg_overrides={"capacity_factor": 1.0}),
    "B3_dots_cap10": dict(_MIX, cfg_overrides={"remat_policy": "dots",
                                               "capacity_factor": 1.0}),
    "A2_tp8": dict(_GRAN),
    "A4_tp8_dots": dict(_GRAN, cfg_overrides={"remat_policy": "dots"}),
    "B5_gather_block_cap10": dict(_MIX, cfg_overrides={
        "moe_dispatch": "gather", "remat_policy": "block",
        "capacity_factor": 1.0}),
    "B5_gather_dots_cap10": dict(_MIX, cfg_overrides={
        "moe_dispatch": "gather", "remat_policy": "dots",
        "capacity_factor": 1.0}),
    "B0_no_remat": dict(_MIX, cfg_overrides={"remat": False}),
    "A2_no_remat": dict(_GRAN, cfg_overrides={"remat": False}),
}
# chip_smoke.py's main path (phase 5 / phase 21) on one card, each policy
_MAIN = dict(arch="bert-large", shape_name=InputShape("main", 128, 16,
                                                      "train"),
             mesh_override="1x1")
EXPS.update({f"main_{pol}": dict(_MAIN, cfg_overrides=over) for pol, over in
             (("block", {"remat_policy": "block"}),
              ("dots", {"remat_policy": "dots"}),
              ("no_remat", {"remat": False}))})


def trace(name: str, layers: Optional[int] = None) -> Dict:
    """One experiment's dry run: ``lower_one``'s report plus ``exp`` and
    the FLOPs of the products with and without batch dimensions."""
    kw = dict(EXPS[name])
    over = dict(kw.pop("cfg_overrides", {}))
    if layers is not None:
        over["n_layers"] = layers
    r = lower_one(cfg_overrides=over or None, **kw)
    ops = r["flops_by_op"]
    r["exp"] = name
    r["mm_flops"] = ops.get("aten.mm", 0) + ops.get("aten.addmm", 0)
    r["bmm_flops"] = ops.get("aten.bmm", 0)
    return r


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=None,
                    help="comma-separated experiment names (default: all)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut n_layers to this for every experiment")
    ap.add_argument("--json", default=None, help="append results to file")
    args = ap.parse_args(argv)
    names = list(EXPS)
    if args.only:
        names = [n for n in args.only.split(",") if n]
        unknown = set(names) - set(EXPS)
        if unknown:
            ap.error(f"unknown experiments {sorted(unknown)}")
    for name in names:
        r = trace(name, args.layers)
        rl = r["roofline"]
        print(f"{name:22s} mesh {r['mesh']} layers "
              f"{args.layers or 'full'}: mm {r['mm_flops']} bmm "
              f"{r['bmm_flops']} dot {rl['dot_flops_per_dev']:.0f} FLOP, "
              f"peak {r['memory']['peak_bytes']} B, t=(c "
              f"{rl['t_compute_s']:.4e}, m {rl['t_memory_s']:.4e}, x "
              f"{rl['t_collective_s']:.4e}) s, trace {r['trace_s']} s",
              flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
