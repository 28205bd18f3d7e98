"""Compressor registry: the C_omega operators behind the optimizer.

A compressor turns a flat float32 vector into a tuple of wire arrays (the
*payload*) plus, for error-feedback use, the exact residual:

    payload, new_err = comp.ef_compress(x, err)    # compress(x + err)
    x_hat            = comp.decompress(payload)    # x + err == x_hat + new_err

Payload contract: every leaf is 1-D and laid out in element order, so
slicing it into ``n`` equal leading chunks slices the represented vector
into its ``n`` contiguous chunks (what the all_to_all relies on).

Registered entries: ``onebit`` (sign + per-block mean-|x| scale, through
the Hopper kernels on CUDA tensors) and ``identity`` (no-op).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.compression import DEFAULT_BLOCK
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


_COMPRESSORS: Dict[str, Callable[..., Compressor]] = {}


def register_compressor(name: str):
    def deco(factory):
        _COMPRESSORS[name] = factory
        return factory
    return deco


register_compressor("onebit")(OneBitCompressor)
register_compressor("identity")(IdentityCompressor)


def get_compressor(name: str, **kwargs) -> Compressor:
    if name not in _COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; "
                       f"registered: {sorted(_COMPRESSORS)}")
    return _COMPRESSORS[name](**kwargs)


def list_compressors():
    return sorted(_COMPRESSORS)
