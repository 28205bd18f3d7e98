"""Compressor registry: the C_omega operators behind the optimizer.

A compressor turns a flat float32 vector into a tuple of wire arrays (the
*payload*) plus, for error-feedback use, the exact residual:

    payload, new_err = comp.ef_compress(x, err)    # compress(x + err)
    x_hat            = comp.decompress(payload)    # x + err == x_hat + new_err

Payload contract: every leaf is 1-D and laid out in element order, so
slicing it into ``n`` equal leading chunks slices the represented vector
into its ``n`` contiguous chunks (what the all_to_all relies on).

Registered entries: ``onebit`` (sign + per-block mean-|x| scale, through
the Hopper kernels on CUDA tensors), ``identity`` (no-op) and ``topk``
(per-block magnitude top-k with error feedback; plain PyTorch on every
device, as the reference computes it outside any Pallas kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.compression import CompressionConfig, DEFAULT_BLOCK
from repro_torch.kernels.onebit import ops as _ops
from repro_torch.plan.ir import WireSpec

Payload = Tuple[torch.Tensor, ...]


class Compressor:
    """Uniform EF-compressor interface (immutable)."""

    name: str = "?"
    lossless: bool = False

    def ef_compress(self, x: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[Payload, torch.Tensor]:
        """Compress ``x + err``; return (payload, exact new residual)."""
        buf = x + err
        payload = self.compress(buf)
        if self.lossless:
            return payload, torch.zeros_like(buf)
        return payload, buf - self.decompress(payload)

    def compress(self, x: torch.Tensor) -> Payload:
        raise NotImplementedError

    def decompress(self, payload: Payload) -> torch.Tensor:
        raise NotImplementedError

    def wire_specs(self, d: int) -> Tuple[WireSpec, ...]:
        """Declared wire format (dtype + shape per payload leaf) of a
        d-element f32 vector — what the plan executor checks against."""
        raise NotImplementedError

    def wire_bytes(self, d: int) -> int:
        return sum(ws.nbytes for ws in self.wire_specs(d))


@dataclasses.dataclass(frozen=True)
class OneBitCompressor(Compressor):
    block_size: int = DEFAULT_BLOCK
    name = "onebit"

    def compress(self, x):
        return _ops.compress(x, self.block_size)

    def ef_compress(self, x, err):
        packed, scales, new_err = _ops.ef_compress_fused(x, err,
                                                         self.block_size)
        return (packed, scales), new_err

    def decompress(self, payload):
        packed, scales = payload
        return _ops.decompress(packed, scales, self.block_size)

    def wire_specs(self, d):
        return (WireSpec("uint8", (d // 8,)),
                WireSpec("float32", (d // self.block_size,)))


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    block_size: int = DEFAULT_BLOCK  # accepted for interface uniformity
    name = "identity"
    lossless = True

    def compress(self, x):
        return (x,)

    def decompress(self, payload):
        return payload[0]

    def wire_specs(self, d):
        return (WireSpec("float32", (d,)),)


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Per-block magnitude top-k with error feedback.

    Each ``block_size`` block keeps its ``k = block_size // ratio`` largest
    |x| entries as (float32 value, intra-block index) pairs, in
    ``torch.topk``'s order (largest first).  Intra-block indexing keeps the
    payload element-ordered and chunkable, and bounds the index by
    ``block_size``, so indices are uint16 up to 65536 (int32 beyond), as
    the reference's ``index_dtype``.  Ties (a block of zeros) may keep
    other indices than ``jax.lax.top_k`` does, with the same values, so
    the decompressed vector and the residual are the same.
    """

    block_size: int = DEFAULT_BLOCK
    ratio: int = 32                  # keep 1/ratio of the elements
    name = "topk"

    def __post_init__(self):
        if self.block_size % self.ratio:
            raise ValueError(f"topk: block_size {self.block_size} is not a "
                             f"multiple of ratio {self.ratio}")

    @property
    def k(self) -> int:
        return max(self.block_size // self.ratio, 1)

    @property
    def index_dtype(self) -> torch.dtype:
        return torch.uint16 if self.block_size <= 65536 else torch.int32

    def compress(self, x):
        if x.ndim != 1 or x.shape[0] % self.block_size:
            raise ValueError(f"topk: a 1-D length that blocks of "
                             f"{self.block_size} divide, got "
                             f"{tuple(x.shape)}")
        xb = x.reshape(-1, self.block_size)
        idx = torch.topk(xb.abs(), self.k, dim=1).indices      # (nb, k)
        vals = torch.gather(xb, 1, idx)                         # (nb, k)
        return vals.reshape(-1), idx.to(self.index_dtype).reshape(-1)

    def decompress(self, payload):
        vals, idx = payload
        nb = vals.shape[0] // self.k
        out = torch.zeros((nb, self.block_size), dtype=vals.dtype,
                          device=vals.device)
        # the kept indices of a block are distinct: no accumulation order
        out.scatter_(1, idx.reshape(nb, self.k).to(torch.int64),
                     vals.reshape(nb, self.k))
        return out.reshape(-1)

    def wire_specs(self, d):
        kept = (d // self.block_size) * self.k
        return (WireSpec("float32", (kept,)),
                WireSpec(str(self.index_dtype).removeprefix("torch."),
                         (kept,)))


_COMPRESSORS: Dict[str, Callable[..., Compressor]] = {}


def register_compressor(name: str):
    def deco(factory):
        _COMPRESSORS[name] = factory
        return factory
    return deco


register_compressor("onebit")(OneBitCompressor)
register_compressor("identity")(IdentityCompressor)
register_compressor("topk")(TopKCompressor)


def get_compressor(name: str, **kwargs) -> Compressor:
    if name not in _COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; "
                       f"registered: {sorted(_COMPRESSORS)}")
    return _COMPRESSORS[name](**kwargs)


def list_compressors():
    return sorted(_COMPRESSORS)


def from_config(cfg: CompressionConfig) -> Compressor:
    """Adapt the legacy ``CompressionConfig`` to a registry compressor."""
    if cfg.kind == "identity":
        return IdentityCompressor(block_size=cfg.block_size)
    return OneBitCompressor(block_size=cfg.block_size)


def as_compressor(obj) -> Compressor:
    """Accept a Compressor, a CompressionConfig, or a registry name."""
    if isinstance(obj, Compressor):
        return obj
    if isinstance(obj, str):
        return get_compressor(obj)
    if isinstance(obj, CompressionConfig):
        return from_config(obj)
    raise TypeError(f"not a compressor: {obj!r}")
