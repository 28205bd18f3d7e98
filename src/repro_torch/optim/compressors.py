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

Beside the wire format each compressor declares its compute
(``compute_specs``), which the cost model prices.  The kernel a tensor
takes follows its device (a CUDA tensor always takes the kernel), so
``compute_specs(d, use_kernel)`` prices the fused path when asked for it
(on a CUDA device spec) and the reference's unfused chain otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.compression import CompressionConfig, DEFAULT_BLOCK
from repro_torch.kernels.onebit import ops as _ops
from repro_torch.perf.kernel_cost import (ZERO_COMPUTE, ComputeSpec,
                                          ef_combine_cost, elementwise_pass)
from repro_torch.plan.ir import WireSpec, log2ceil

Payload = Tuple[torch.Tensor, ...]


class Compressor:
    """Uniform EF-compressor interface (immutable)."""

    name: str = "?"
    lossless: bool = False
    # dense = every coordinate survives compression (possibly quantised);
    # a sparse compressor (dense=False) drops coordinates and needs error
    # feedback on every lossy hop (plan.schedules.needs_outer_ef)
    dense: bool = True

    def ef_compress(self, x: torch.Tensor, err: torch.Tensor,
                    out: Optional[torch.Tensor] = None
                    ) -> Tuple[Payload, torch.Tensor]:
        """Compress ``x + err``; return (payload, exact new residual).
        ``out``, when given, receives the residual (it must not overlap
        ``x`` or ``err``)."""
        buf = x + err
        payload = self.compress(buf)
        if self.lossless:
            return payload, (torch.zeros_like(buf) if out is None
                             else out.zero_())
        return payload, torch.sub(buf, self.decompress(payload), out=out)

    def compress(self, x: torch.Tensor) -> Payload:
        raise NotImplementedError

    def decompress(self, payload: Payload,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The ``(d,)`` f32 vector ``payload`` represents, written into
        ``out`` when given."""
        raise NotImplementedError

    def wire_specs(self, d: int) -> Tuple[WireSpec, ...]:
        """Declared wire format (dtype + shape per payload leaf) of a
        d-element f32 vector — what the plan executor checks against."""
        raise NotImplementedError

    def wire_bytes(self, d: int) -> int:
        return sum(ws.nbytes for ws in self.wire_specs(d))

    # --- declared compute (repro_torch.perf), next to the wire format ----
    has_kernel = False   # a fused CUDA path exists for CUDA tensors

    def _compress_cost(self, d: int, use_kernel: bool) -> ComputeSpec:
        raise NotImplementedError

    def _decompress_cost(self, d: int, use_kernel: bool) -> ComputeSpec:
        raise NotImplementedError

    def compute_specs(self, d: int, use_kernel: bool = False
                      ) -> Dict[str, ComputeSpec]:
        """Declared compute of a d-element f32 vector, keyed
        ``compress`` / ``decompress`` / ``ef_compress``: the compute
        analogue of ``wire_specs``, priced by ``repro_torch.plan.cost``.
        ``use_kernel`` prices the fused CUDA path (what a CUDA tensor
        runs) where the compressor has one.  The base composition is the
        base ``ef_compress``: an add pass, a compress, a decompress and a
        residual pass."""
        c = self._compress_cost(d, use_kernel)
        dc = self._decompress_cost(d, use_kernel)
        return {"compress": c, "decompress": dc,
                "ef_compress": ef_combine_cost(d) + c + dc}


@dataclasses.dataclass(frozen=True)
class OneBitCompressor(Compressor):
    block_size: int = DEFAULT_BLOCK
    name = "onebit"
    has_kernel = True

    def compress(self, x):
        return _ops.compress(x, self.block_size)

    def ef_compress(self, x, err, out=None):
        packed, scales, new_err = _ops.ef_compress_fused(
            x, err, self.block_size, out=out)
        return (packed, scales), new_err

    def decompress(self, payload, out=None):
        packed, scales = payload
        return _ops.decompress(packed, scales, self.block_size, out=out)

    def wire_specs(self, d):
        return (WireSpec("uint8", (d // 8,)),
                WireSpec("float32", (d // self.block_size,)))

    # traffic of csrc/onebit.cu (fused: one launch, each array once) and of
    # the reference's unfused chain (a pack pass and a scale pass; unpack
    # materialises the (d,) sign vector before the scale multiply)
    def _compress_cost(self, d, use_kernel):
        w = self.wire_bytes(d)
        if use_kernel:
            return ComputeSpec(flops=2.0 * d, hbm_bytes=4 * d + w,
                               kernels=1)
        return ComputeSpec(flops=2.0 * d, hbm_bytes=8 * d + w, kernels=2)

    def _decompress_cost(self, d, use_kernel):
        w = self.wire_bytes(d)
        if use_kernel:
            return ComputeSpec(flops=2.0 * d, hbm_bytes=w + 4 * d,
                               kernels=1)
        return ComputeSpec(flops=2.0 * d, hbm_bytes=w + 12 * d, kernels=2)

    def compute_specs(self, d, use_kernel=False):
        specs = super().compute_specs(d, use_kernel)
        if use_kernel:
            # repro_ef_compress: buf, scale, pack and residual in one pass
            # reading x and err, writing new_err and the payload
            specs["ef_compress"] = ComputeSpec(
                flops=4.0 * d, hbm_bytes=12 * d + self.wire_bytes(d),
                kernels=1)
        return specs


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    block_size: int = DEFAULT_BLOCK  # accepted for interface uniformity
    name = "identity"
    lossless = True

    def compress(self, x):
        return (x,)

    def decompress(self, payload, out=None):
        return payload[0] if out is None else out.copy_(payload[0])

    def wire_specs(self, d):
        return (WireSpec("float32", (d,)),)

    def compute_specs(self, d, use_kernel=False):
        # the payload is the buffer: ef_compress is one add pass
        return {"compress": ZERO_COMPUTE, "decompress": ZERO_COMPUTE,
                "ef_compress": elementwise_pass(d, 2, 1)}


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
    dense = False

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

    def decompress(self, payload, out=None):
        vals, idx = payload
        nb = vals.shape[0] // self.k
        if out is None:
            out = torch.empty(nb * self.block_size, dtype=vals.dtype,
                              device=vals.device)
        dense = out.zero_().view(nb, self.block_size)
        # the kept indices of a block are distinct: no accumulation order
        dense.scatter_(1, idx.reshape(nb, self.k).to(torch.int64),
                       vals.reshape(nb, self.k))
        return out

    def wire_specs(self, d):
        kept = (d // self.block_size) * self.k
        return (WireSpec("float32", (kept,)),
                WireSpec(str(self.index_dtype).removeprefix("torch."),
                         (kept,)))

    def _compress_cost(self, d, use_kernel):
        # abs pass + per-block top-k (O(B log B) a block) + value gather;
        # reads x twice, writes the (vals, idx) payload
        w = self.wire_bytes(d)
        return ComputeSpec(flops=float(d) * max(log2ceil(self.block_size),
                                                1),
                           hbm_bytes=8 * d + w, kernels=3)

    def _decompress_cost(self, d, use_kernel):
        # zero fill + scatter of the kept (value, index) pairs
        w = self.wire_bytes(d)
        return ComputeSpec(flops=float(d), hbm_bytes=4 * d + 2 * w,
                           kernels=2)


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


def compressor_has_kernel(name: str) -> bool:
    """True when the registered entry has a fused CUDA path (checked
    without constructing it): the tuner's kernel axis reads it."""
    if name not in _COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; "
                       f"registered: {sorted(_COMPRESSORS)}")
    return bool(getattr(_COMPRESSORS[name], "has_kernel", False))


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
