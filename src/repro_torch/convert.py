"""Carry parameters and optimizer state across from and to the JAX
reference.

Parameters: ``params_from_jax`` takes the reference's parameter pytree as
numpy arrays (nested dicts, stacked ``blocks`` leaves) and returns the
port's params, a dict from dotted path to f32 tensor, same shapes, in
ravel order; ``params_to_jax`` is its inverse.  ``flat_from_params``
concatenates the port's params in ``ravel_pytree`` order — sorted keys at
every level, each leaf in C order — so the flat vector, and with it every
compression scale block, covers the same elements as the reference's;
``params_from_flat`` cuts a flat vector back into them.  Under tensor
parallelism a model rank holds the contiguous shard of each leaf along the
dim ``models.transformer.param_specs`` names: ``shard_params`` cuts rank
r's shards out of the global params, ``unshard_params`` joins every
rank's back into them.

Optimizer state: the reference holds one GLOBAL array per slot (the
shapes of ``repro_torch.state.slots.global_shapes``: replicated slots
``(tp, L)``, per-dp-rank and dp-sharded slots ``(*dp_sizes, tp, L)``,
scalars ``()``), the port one per-rank tensor per slot.
``state_to_global`` assembles the global arrays from every rank's state
(rank order: dp index * tp + model index); ``state_from_global`` takes one
rank's tensors out of them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.state.slots import (DTYPES, SlotSpec, StateLayout,
                                     StateTree, global_shapes)


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


def params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """{dotted path: tensor} -> the reference's nested dict of f32 numpy
    arrays (the inverse of :func:`params_from_jax`)."""
    out: dict = {}
    for path, t in params.items():
        *heads, leaf = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.detach().to(torch.float32).cpu().numpy()
    return out


def ravel_shapes(params: Mapping[str, torch.Tensor]
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """The (path, shape) leaves of ``params`` in ravel order, as
    :func:`params_from_flat` takes them."""
    return [(p, tuple(params[p].shape))
            for p in sorted(params, key=lambda p: p.split("."))]


def flat_from_params(params: Mapping[str, torch.Tensor],
                     d_pad: Optional[int] = None) -> torch.Tensor:
    """The params as one f32 vector in ravel order, zero-padded to
    ``d_pad`` when given."""
    flat = torch.cat([params[p].reshape(-1).to(torch.float32)
                      for p, _ in ravel_shapes(params)])
    if d_pad is not None:
        if d_pad < flat.shape[0]:
            raise ValueError(f"d_pad={d_pad} < {flat.shape[0]} parameters")
        flat = torch.nn.functional.pad(flat, (0, d_pad - flat.shape[0]))
    return flat


def params_from_flat(flat: torch.Tensor,
                     shapes: Sequence[Tuple[str, Tuple[int, ...]]]
                     ) -> Dict[str, torch.Tensor]:
    """Views of ``flat`` as {dotted path: tensor of its shape}, for the
    (path, shape) leaves in ravel order (the padding tail is left out)."""
    out, off = {}, 0
    for path, shape in shapes:
        n = math.prod(shape)
        out[path] = flat[off:off + n].view(shape)
        off += n
    return out


def shard_leaf(t: torch.Tensor, dim: Optional[int], tp: int, rank: int
               ) -> torch.Tensor:
    """Model rank ``rank``'s contiguous shard (a view) of a global leaf
    split along ``dim`` into ``tp`` pieces (None: replicated, whole)."""
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"{tuple(t.shape)}: dim {dim} does not split over "
                         f"{tp} model ranks")
    size = t.shape[dim] // tp
    return t.narrow(dim, rank * size, size)


def shard_params(params: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Optional[int]], tp: int, rank: int
                 ) -> Dict[str, torch.Tensor]:
    """Model rank ``rank``'s shards (views) of the global ``params``, each
    leaf cut along its ``specs`` dim."""
    return {path: shard_leaf(t, specs[path], tp, rank)
            for path, t in params.items()}


def unshard_params(shards: Sequence[Mapping[str, torch.Tensor]],
                   specs: Mapping[str, Optional[int]]
                   ) -> Dict[str, torch.Tensor]:
    """The global params from every model rank's shards (rank order):
    split leaves concatenated along their dim, replicated ones rank 0's."""
    out = {}
    for path, t in shards[0].items():
        dim = specs[path]
        out[path] = t if dim is None or len(shards) == 1 else \
            torch.cat([sh[path] for sh in shards], dim=dim)
    return out


def state_to_global(rank_states: Sequence[Mapping[str, torch.Tensor]],
                    slots: Sequence[SlotSpec], ctx: StateLayout
                    ) -> StateTree:
    """Every rank's per-rank state (rank order: dp index * tp + model
    index) -> the reference's global numpy arrays.  Replicated slots are
    the model ranks' of dp rank 0 (``(tp, L)``), scalars rank 0's."""
    tp = max(ctx.tp, 1)
    if len(rank_states) != max(ctx.n_dp, 1) * tp:
        raise ValueError(f"{len(rank_states)} rank states for n_dp = "
                         f"{ctx.n_dp} x tp = {tp}")
    out = {}
    for s in slots:
        shape, dtype = global_shapes((s,), ctx)[s.name]
        if s.extent == "scalar":
            a = _host(rank_states[0][s.name], dtype)
        elif s.replication == "replicated":
            a = np.stack([_host(st[s.name], dtype)
                          for st in rank_states[:tp]])
        else:
            a = np.stack([_host(st[s.name], dtype) for st in rank_states])
        out[s.name] = a.reshape(shape)
    return StateTree(out)


def state_from_global(glob: Mapping[str, np.ndarray],
                      slots: Sequence[SlotSpec], ctx: StateLayout,
                      rank: int = 0, device="cpu",
                      model_rank: int = 0) -> StateTree:
    """The per-rank tensors of dp rank ``rank``, model rank ``model_rank``
    out of the reference's global arrays."""
    tp = max(ctx.tp, 1)
    out = {}
    for s in slots:
        shape, dtype = global_shapes((s,), ctx)[s.name]
        a = np.asarray(glob[s.name])
        if a.shape != shape:
            raise ValueError(f"slot {s.name}: global shape {a.shape}, "
                             f"expected {shape}")
        if s.extent != "scalar":
            a = a.reshape(tp, -1)[model_rank] \
                if s.replication == "replicated" else \
                a.reshape(max(ctx.n_dp, 1), tp, -1)[rank, model_rank]
        out[s.name] = torch.from_numpy(
            np.array(a, dtype=dtype)).to(device=device,
                                          dtype=DTYPES[s.dtype])
    return StateTree(out)


def _host(t, dtype) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=dtype)
