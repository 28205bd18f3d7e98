"""Ablation: compression block size (the scale granularity of C_omega).

The port of ``benchmarks/block_size_ablation.py``.  The paper uses
per-chunk l2 scaling; the compressor uses per-block mean-|x| (the
l2-optimal sign scale).  This ablation sweeps the block size and reports
  * relative compression error ||x - C(x)|| / ||x||  (Assumption 1's eps),
  * wire bytes per fp32 parameter,
  * toy convergence (quadratic, 1-bit Adam) vs the uncompressed optimum,
showing the error/overhead trade-off that motivates the 4096 default.

  python -m repro_torch.benchmarks.block_size_ablation [--device cpu]

On the card, compression runs through the ``ef_compress`` and
``decompress`` kernels.  The input of the error measurement is the
reference's numpy array; the toy's gradient noise comes from a seeded
``torch.Generator`` (the reference draws it from ``jax.random``).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core import (CompressionConfig, OneBitAdamConfig,
                              compress_onebit, compressed_update,
                              decompress_onebit, onebit_adam_init,
                              warmup_update, wire_bytes)
from repro_torch.launch.train import resolve_device

D = 1 << 16
BLOCKS = (256, 1024, 4096, 16384)


def _rel_error(block: int, seed: int = 0, device="cpu") -> float:
    """Heteroscedastic input (magnitude varies smoothly across the vector,
    like per-layer gradient scales in a real flattened pytree): small
    blocks track the local scale, large blocks smear it — for iid data the
    block size would be invisible (mean|x| identical everywhere)."""
    rng = np.random.default_rng(seed)
    scale = np.exp(np.linspace(-3.0, 3.0, D)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32)
                         * scale).to(device)
    pk, sc = compress_onebit(x, block)
    y = decompress_onebit(pk, sc, block)
    return float(torch.linalg.vector_norm(x - y)
                 / torch.linalg.vector_norm(x))


def _toy_loss(block: int, steps: int = 250, warmup: int = 50,
              device="cpu") -> float:
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 5.0, (D,)).astype(np.float32)
                         ).to(device)
    t = torch.from_numpy(rng.normal(size=(D,)).astype(np.float32)
                         ).to(device)
    cfg = OneBitAdamConfig(compression=CompressionConfig(block_size=block))
    st = onebit_adam_init(D, 1, device)
    x = torch.zeros(D, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    for i in range(steps):
        g = a * (x - t) + 0.1 * torch.randn(D, generator=gen, device=device)
        step = warmup_update if i < warmup else compressed_update
        x, st, _ = step(g, st, x, cfg, 5e-2)
    return float(0.5 * torch.sum(a * (x - t) ** 2))


def passes(rows: Dict[int, dict]) -> bool:
    """The reference's PASS rule: the error grows with the block size and
    4096 stays under 1.04 bits per parameter."""
    errs = [rows[b]["rel_error"] for b in BLOCKS]
    return (errs == sorted(errs) and errs[-1] > errs[0] + 0.01
            and rows[4096]["bits_per_param"] < 1.04)


def run(verbose: bool = True, device: str = "cuda") -> Dict[int, dict]:
    dev = resolve_device(device)
    rows = {}
    for b in BLOCKS:
        rows[b] = {
            "rel_error": round(_rel_error(b, device=dev), 4),
            "bits_per_param": round(
                8 * wire_bytes(D, CompressionConfig(block_size=b)) / D, 3),
            "toy_final_loss": round(_toy_loss(b, device=dev), 4),
        }
    if verbose:
        print("== block_size_ablation ==")
        for b, r in rows.items():
            print(f"  block {b:6d}: err {r['rel_error']:.3f}  "
                  f"{r['bits_per_param']:.3f} bits/param  "
                  f"toy loss {r['toy_final_loss']}")
        print(f"  [{'PASS' if passes(rows) else 'FAIL'}] error grows with "
              f"block size; 4096 stays ~1 bit/param with stable convergence")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    run(device=ap.parse_args().device)
