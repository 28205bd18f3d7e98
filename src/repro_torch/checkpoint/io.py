"""Minimal npz pytree checkpointing, in the reference's archive format.

A tree is nested dicts, tuples/lists and :class:`~repro_torch.state.slots.
StateTree`s over tensor or array leaves.  Each leaf is copied to the host
and stored under its tree path, the path elements joined by ``|``: a dict
key as itself (dicts in sorted key order, as ``jax.tree_util`` flattens
them), a tuple index as its number, a state slot as ``.<name>`` (the
reference's ``GetAttrKey``).  The step is stored as ``__step__`` and each
meta entry as ``__meta_<k>__``, so an archive written here loads in the
reference's ``repro.checkpoint.io`` and the reverse.  Writes are atomic: a
temporary file in the target's directory, then ``os.replace``.

The port's copy of ``repro/checkpoint/io.py``.
"""
from __future__ import annotations

import os
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.state.slots import StateTree

_SEP = "|"
_META = "__meta_"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> Tuple[List[Tuple[str, Any]], Callable[[List[Any]], Any]]:
    """(key, leaf) pairs in flattening order and a function that rebuilds
    the tree's structure from a list of leaves in that order."""
    if isinstance(tree, StateTree):
        names = list(tree)
        parts = [_flatten(tree[k], prefix + ("." + k,)) for k in names]
        rebuild = lambda ls: StateTree(  # noqa: E731
            dict(zip(names, _split(parts, ls))))
    elif isinstance(tree, Mapping):
        names = sorted(tree)
        parts = [_flatten(tree[k], prefix + (str(k),)) for k in names]
        rebuild = lambda ls: dict(  # noqa: E731
            zip(names, _split(parts, ls)))
    elif isinstance(tree, (tuple, list)):
        parts = [_flatten(t, prefix + (str(i),)) for i, t in enumerate(tree)]
        kind = type(tree)
        rebuild = lambda ls: kind(_split(parts, ls))  # noqa: E731
    else:
        return [(_SEP.join(prefix) or "_root", tree)], lambda ls: ls[0]
    return [kv for items, _ in parts for kv in items], rebuild


def _split(parts, leaves: List[Any]) -> List[Any]:
    out, off = [], 0
    for items, rebuild in parts:
        out.append(rebuild(leaves[off:off + len(items)]))
        off += len(items)
    return out


def flatten_with_keys(tree: Any) -> Dict[str, Any]:
    """{archive key: leaf} of ``tree``, in flattening order."""
    return dict(_flatten(tree)[0])


def save_pytree(path: str, tree: Any, step: int = 0,
                meta: Mapping[str, Any] = None) -> None:
    """``meta``: optional dict of scalars describing how the state was
    produced, read back with :func:`load_meta`."""
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree)[0]}
    arrays["__step__"] = np.asarray(step)
    for k, v in (meta or {}).items():
        arrays[f"{_META}{k}__"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any, backfill: bool = False
                ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` as numpy arrays; returns
    ``(tree, step)``.  Every stored leaf must have its template's shape.

    Strict by default: a template leaf missing from the archive raises
    ``KeyError``.  ``backfill=True`` fills it from the template instead
    (and warns), so archives written before a leaf existed stay loadable;
    optimizer-state resumes go through
    ``repro_torch.state.checkpoint.load_train_state``, which names the
    missing slots from the slot declarations."""
    items, rebuild = _flatten(like)
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        keys = set(data.files)
        missing = [k for k, _ in items if k not in keys]
        if missing and not backfill:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}"
                           "...")
        if missing:
            warnings.warn(f"checkpoint {path} missing {sorted(missing)[:5]}; "
                          "filling from the template (new optimizer-state "
                          "fields start at their init)")
        leaves = []
        for k, ref in items:
            if k not in keys:
                leaves.append(_to_numpy(ref))
                continue
            arr = data[k]
            if arr.shape != tuple(np.shape(ref)):
                raise ValueError(f"checkpoint {path}: {k} has shape "
                                 f"{arr.shape}, the template "
                                 f"{tuple(np.shape(ref))}")
            leaves.append(arr)
    return rebuild(leaves), step


def load_meta(path: str) -> dict:
    """The ``meta`` dict a checkpoint was saved with ({} for checkpoints
    predating metadata)."""
    with np.load(path) as data:
        return {k[len(_META):-2]: data[k].item()
                for k in data.files if k.startswith(_META)}
