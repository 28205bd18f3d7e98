"""Declarative optimizer-state slots (the replicated layout of slice 1).

The optimizer declares its state once as a tuple of :class:`SlotSpec`s —
name, extent, replication, dtype — and :func:`init_rank_state` builds the
per-rank zeros from the declarations.

Extents (per rank): ``per_param`` (length ``d``), ``per_chunk`` (``d``
divided by the server group), ``per_segment`` (one per ``ravel_pytree``
segment) and ``scalar``.  Replications: ``replicated`` (every dp rank
holds the same values) and ``per_dp_rank`` (EF state: each rank its own).
The ``local`` and ``zero1`` layouts of the reference are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence

import torch

EXTENTS = ("per_param", "per_chunk", "per_segment", "scalar")
REPLICATIONS = ("replicated", "per_dp_rank")


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One declared optimizer-state slot."""

    name: str
    extent: str = "per_param"
    replication: str = "replicated"
    dtype: str = "float32"
    ef: Optional[str] = None          # plan err-slot this state slot backs

    def __post_init__(self):
        if self.extent not in EXTENTS:
            raise ValueError(f"{self.name}: unknown extent {self.extent!r}")
        if self.replication not in REPLICATIONS:
            raise ValueError(f"{self.name}: unknown replication "
                             f"{self.replication!r}")


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """``d``: padded flat length; ``n_dp``: ranks on the dp axis (also the
    server-chunk group on the flat topology); ``n_segments``: segment
    count."""

    d: int
    n_dp: int = 1
    n_segments: int = 1

    def __post_init__(self):
        if self.d % max(self.n_dp, 1):
            raise ValueError(f"d={self.d} does not split over {self.n_dp}")


def slot_length(spec: SlotSpec, ctx: StateLayout) -> Optional[int]:
    """Per-rank element count of ``spec`` (None for scalars)."""
    if spec.extent == "per_param":
        return ctx.d
    if spec.extent == "per_chunk":
        return ctx.d // max(ctx.n_dp, 1)
    if spec.extent == "per_segment":
        return ctx.n_segments
    return None


class StateTree(Mapping):
    """Ordered, attribute-accessible, immutable mapping of state slots."""

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any] = (), **kw: Any):
        d = dict(data)
        d.update(kw)
        object.__setattr__(self, "_data", d)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any):
        raise AttributeError("StateTree is immutable; use _replace")

    def _replace(self, **kw: Any) -> "StateTree":
        unknown = set(kw) - set(self._data)
        if unknown:
            raise KeyError(f"unknown state slots: {sorted(unknown)}")
        return StateTree({k: kw.get(k, v) for k, v in self._data.items()})

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={getattr(v, 'dtype', '')}"
                          f"{list(getattr(v, 'shape', ()))}"
                          for k, v in self._data.items())
        return f"StateTree({inner})"


_DTYPES = {"float32": torch.float32, "int32": torch.int32}


def init_rank_state(slots: Sequence[SlotSpec], ctx: StateLayout,
                    device) -> StateTree:
    """Zeros per-rank state on ``device``."""
    out = {}
    for s in slots:
        n = slot_length(s, ctx)
        out[s.name] = torch.zeros(() if n is None else (n,),
                                  dtype=_DTYPES[s.dtype], device=device)
    return StateTree(out)


def ef_errs(state: Mapping[str, Any],
            slots: Sequence[SlotSpec]) -> Dict[str, Any]:
    """The plan-executor errs dict backed by ``state``'s EF slots."""
    return {s.ef: state[s.name] for s in slots if s.ef is not None}
