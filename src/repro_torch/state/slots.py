"""Declarative optimizer-state slots.

The optimizer declares its state once as a tuple of :class:`SlotSpec`s —
name, extent, replication, dtype — and the machinery here derives the
per-rank zeros (:func:`init_rank_state`), the global (all-ranks) shapes a
checkpoint stores (:func:`global_shapes`) and the per-rank state bytes
(:func:`state_bytes`) from the declarations.

Extents (how long the slot is, per rank):

  ``per_param``    one element per flat parameter (length ``d``);
  ``per_chunk``    ``d`` divided by the divisor named in ``chunk_of``:
                   ``"dp"`` (all dp ranks, the ZeRO-1 ``v``/master shards),
                   ``"server"`` (the server-chunk group: all of dp on the
                   flat topology, the intra-pod group on hier) or
                   ``"total"`` (server group x pods);
  ``per_segment``  one element per ``ravel_pytree`` segment (the LAMB trust
                   ratios);
  ``scalar``       a single scalar (step counters).

Replications (who holds which values):

  ``replicated``   every dp rank holds the same values;
  ``per_dp_rank``  every dp rank holds its own values (EF residuals, and
                   the ``local`` layout's adaptive state);
  ``dp_sharded``   the dp ranks partition one logical ``per_param`` vector
                   (ZeRO-1 ``v_shard``/``master_shard``).

EF slots also name the plan error slot they back (``ef=``) and whether
their run layout follows the pipeline bucket structure
(``bucket_keyed=True``; see ``repro_torch.state.layout``).

The port's copy of ``repro/state/slots.py``; the PartitionSpecs of the
reference (``state_specs``) have no counterpart, since each process here
is one rank and holds its per-rank tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

EXTENTS = ("per_param", "per_chunk", "per_segment", "scalar")
REPLICATIONS = ("replicated", "per_dp_rank", "dp_sharded")
CHUNK_DIVISORS = ("dp", "server", "total")


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One declared optimizer-state slot (see module docstring)."""

    name: str
    extent: str = "per_param"
    replication: str = "replicated"
    dtype: str = "float32"
    chunk_of: str = "server"          # per_chunk divisor name
    ef: Optional[str] = None          # plan err-slot this state slot backs
    bucket_keyed: bool = False        # run layout follows bucket structure

    def __post_init__(self):
        if self.extent not in EXTENTS:
            raise ValueError(f"{self.name}: unknown extent {self.extent!r}")
        if self.replication not in REPLICATIONS:
            raise ValueError(f"{self.name}: unknown replication "
                             f"{self.replication!r}")
        if self.chunk_of not in CHUNK_DIVISORS:
            raise ValueError(f"{self.name}: unknown chunk_of "
                             f"{self.chunk_of!r}")
        if self.extent == "scalar" and self.replication != "replicated":
            raise ValueError(f"{self.name}: scalar slots must be replicated")
        # dp_sharded means the ranks PARTITION one logical per-param vector:
        # the slot must be its per-rank chunk, not a full per-rank copy
        if self.replication == "dp_sharded" and (
                self.extent != "per_chunk" or self.chunk_of != "dp"):
            raise ValueError(f"{self.name}: dp_sharded slots must be "
                             "per_chunk over dp")
        if self.bucket_keyed and self.extent != "per_chunk":
            raise ValueError(f"{self.name}: only per_chunk slots can be "
                             "bucket-keyed")

    def manifest(self) -> Dict[str, object]:
        return {"name": self.name, "extent": self.extent,
                "replication": self.replication, "dtype": self.dtype,
                "chunk_of": self.chunk_of if self.extent == "per_chunk"
                else None,
                "ef": self.ef, "bucket_keyed": self.bucket_keyed}


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Static materialisation context for a slot set.

    ``d`` is the padded flat parameter length; ``n_srv`` the server-chunk
    group size (``n_dp`` on the flat topology); ``n_outer`` the pod count
    (1 = flat).  ``dp_sizes``/``tp`` shape the global arrays only.
    """

    d: int
    n_dp: int = 1
    n_srv: int = 1
    n_outer: int = 1
    n_segments: int = 1
    dp_sizes: Tuple[int, ...] = ()
    tp: int = 1

    def __post_init__(self):
        if self.d % self.chunk_divisor("dp") or \
                self.d % self.chunk_divisor("total"):
            raise ValueError(f"d={self.d} does not split over the dp ranks "
                             f"and server groups of {self}")
        if self.dp_sizes and math.prod(self.dp_sizes) != self.n_dp:
            raise ValueError(f"dp_sizes {self.dp_sizes} do not multiply to "
                             f"n_dp = {self.n_dp}")

    def chunk_divisor(self, chunk_of: str) -> int:
        return {"dp": max(self.n_dp, 1),
                "server": max(self.n_srv, 1),
                "total": max(self.n_srv, 1) * max(self.n_outer, 1)
                }[chunk_of]


def flat_layout(d: int, n_dp: int = 1, n_segments: int = 1,
                tp: int = 1) -> StateLayout:
    """The flat topology's context on a dp axis of ``n_dp`` ranks (each
    model rank's, with a model axis of ``tp``): every rank serves one
    chunk, one dp mesh dim."""
    n = max(n_dp, 1)
    return StateLayout(d=d, n_dp=n, n_srv=n, n_outer=1,
                       n_segments=max(n_segments, 1), dp_sizes=(n,), tp=tp)


def slot_length(spec: SlotSpec, ctx: StateLayout) -> Optional[int]:
    """Per-rank element count of ``spec`` (None for scalars)."""
    if spec.extent == "per_param":
        return ctx.d
    if spec.extent == "per_chunk":
        return ctx.d // ctx.chunk_divisor(spec.chunk_of)
    if spec.extent == "per_segment":
        return ctx.n_segments
    return None


def state_bytes(slots: Sequence[SlotSpec], ctx: StateLayout) -> int:
    """Optimizer-state bytes ONE dp rank holds: ``dp_sharded`` slots cost
    their shard, everything else its full per-rank extent."""
    total = 0
    for s in slots:
        n = slot_length(s, ctx)
        total += np.dtype(s.dtype).itemsize * (1 if n is None else n)
    return total


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

    def __contains__(self, key: object) -> bool:
        return key in self._data

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

    def map(self, fn: Callable[[Any], Any]) -> "StateTree":
        return StateTree({k: fn(v) for k, v in self._data.items()})

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={getattr(v, 'dtype', '')}"
                          f"{list(getattr(v, 'shape', ()))}"
                          for k, v in self._data.items())
        return f"StateTree({inner})"


DTYPES = {"float32": torch.float32, "int32": torch.int32}


def init_rank_state(slots: Sequence[SlotSpec], ctx: StateLayout,
                    device="cpu") -> StateTree:
    """Zeros per-rank state on ``device``."""
    out = {}
    for s in slots:
        n = slot_length(s, ctx)
        out[s.name] = torch.zeros(() if n is None else (n,),
                                  dtype=DTYPES[s.dtype], device=device)
    return StateTree(out)


def global_shapes(slots: Sequence[SlotSpec], ctx: StateLayout
                  ) -> StateTree:
    """Global (all-ranks) (shape, numpy dtype) pairs, as the reference
    materialises them: replicated slots are ``(tp, L)``; per-dp-rank and
    dp-sharded slots gain the leading ``(*dp_sizes,)`` dims; scalars stay
    ``()``."""
    out = {}
    for s in slots:
        n = slot_length(s, ctx)
        if n is None:
            out[s.name] = ((), np.dtype(s.dtype))
            continue
        lead = (tuple(ctx.dp_sizes) if s.replication != "replicated"
                else ())
        out[s.name] = (lead + (ctx.tp, n), np.dtype(s.dtype))
    return StateTree(out)


def ef_errs(state: Mapping[str, Any],
            slots: Sequence[SlotSpec]) -> Dict[str, Any]:
    """The plan-executor errs dict backed by ``state``'s EF slots."""
    return {s.ef: state[s.name] for s in slots if s.ef is not None}
