"""Carry parameters across from the JAX reference.

``params_from_jax`` takes the reference's parameter pytree as numpy arrays
(nested dicts, stacked ``blocks`` leaves) and returns the port's params:
a dict from dotted path to f32 tensor, same shapes, in ravel order.
``flat_from_params`` concatenates them in ``ravel_pytree`` order — sorted
keys at every level, each leaf in C order — so the flat vector, and with
it every compression scale block, covers the same elements as the
reference's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of array-likes -> {dotted path: f32 tensor}."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k in sorted(node):
            if isinstance(node[k], Mapping):
                walk(node[k], prefix + k + ".")
            else:
                a = np.ascontiguousarray(np.asarray(node[k], np.float32))
                out[prefix + k] = torch.from_numpy(a.copy())
    walk(tree, "")
    return out


def flat_from_params(params: Mapping[str, torch.Tensor],
                     d_pad: Optional[int] = None) -> torch.Tensor:
    """The params as one f32 vector in ravel order, zero-padded to
    ``d_pad`` when given."""
    paths = sorted(params, key=lambda p: p.split("."))
    flat = torch.cat([params[p].reshape(-1).to(torch.float32)
                      for p in paths])
    if d_pad is not None:
        if d_pad < flat.shape[0]:
            raise ValueError(f"d_pad={d_pad} < {flat.shape[0]} parameters")
        flat = torch.nn.functional.pad(flat, (0, d_pad - flat.shape[0]))
    return flat
