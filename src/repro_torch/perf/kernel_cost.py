"""ComputeSpec — declared FLOP/HBM-byte counts of the optimizer hot path.

A :class:`ComputeSpec` is to compute what
:class:`~repro_torch.plan.ir.WireSpec` is to communication: a static,
declared account of what an operation costs, priced against a
:class:`~repro_torch.perf.device.DeviceSpec` by the roofline formula

    t = max(flops / peak_flops, hbm_bytes / hbm_bw) + kernels * overhead.

Compressors declare their own specs next to ``wire_specs``
(:meth:`repro_torch.optim.compressors.Compressor.compute_specs`); this
module holds the shared vocabulary plus the specs that are not
compressor-owned (the fused and unfused Adam update, elementwise passes,
the EF fold, the all_to_all combine).

Byte counts are pass counts over HBM, each input read once and each
output written once:

  * ``csrc/onebit.cu`` ``repro_ef_compress``: reads x and err, writes
    new_err and the wire payload (d/8 packed bytes + one f32 scale a
    block): 12d + d/8 + 4d/block bytes, one launch; ``repro_decompress``
    reads the payload and writes d f32: 4d + d/8 + 4d/block;
  * ``csrc/fused_adam.cu`` ``repro_adam_step``: 4 reads (x, m, v, g) and
    3 writes (x, m, v), 28d bytes, one launch; the unfused chain
    materialises the m/v EMAs and the update: 6 reads + 5 writes over 5
    kernels.

  * ``csrc/flash_attn_sm90*.cu``: reads q, k, v and writes o once
    (4 B H S D elements), and does 4 D operations for every (query, key)
    pair the mask lets through (:func:`flash_attention_cost`).

  * ``csrc/lm_head_xent.cu``: the LM head and its cross-entropy, counted
    as the bf16 tensor-core products it runs, 2 T d V_l operations each
    (:func:`lm_head_xent_cost`).

  * ``csrc/moe_dispatch.cu``: the dropless expert layer's permute and
    combine move rows of d elements by index, counted at the launch's
    true row counts (:func:`moe_permute_cost`, :func:`moe_combine_cost`):
    ``filled`` rows of the T k buffer hold a pair, ``tokens`` tokens have
    at least one.

These are the byte counts of PERF.md's bound column, and the tests pin
the closed forms to the reference's (``tests/test_torch_perf.py``).  The
dry run (``launch.dryrun``) prices every kernel launch of a traced step
with them (``ef_compress_cost``, ``decompress_cost``,
``adam_update_cost(fused=True)``, ``flash_attention_cost``).
"""
from __future__ import annotations

import dataclasses

F32 = 4  # bytes per float32 element


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Declared cost of one compute step: FLOPs + HBM traffic + number
    of kernel launches.  Additive: composing steps sums fields."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    kernels: int = 0

    def __add__(self, other: "ComputeSpec") -> "ComputeSpec":
        return ComputeSpec(self.flops + other.flops,
                           self.hbm_bytes + other.hbm_bytes,
                           self.kernels + other.kernels)

    def time(self, device) -> float:
        """Roofline seconds on ``device`` (a DeviceSpec)."""
        return device.roofline_time(self.flops, self.hbm_bytes,
                                    self.kernels)


ZERO_COMPUTE = ComputeSpec()


def elementwise_pass(d: int, n_read: int, n_write: int,
                     flops_per_elem: float = 1.0) -> ComputeSpec:
    """One elementwise kernel over ``d`` f32 elements reading ``n_read``
    operands and writing ``n_write`` results."""
    return ComputeSpec(flops=flops_per_elem * d,
                       hbm_bytes=F32 * d * (n_read + n_write),
                       kernels=1)


def adam_update_cost(d: int, fused: bool) -> ComputeSpec:
    """The elementwise Adam update over ``d`` f32 elements: fused (the
    ``adam_step`` kernel) one pass of 4 reads + 3 writes; unfused, 6
    reads + 5 writes over 5 kernels.  ~12 flops an element either way
    (two EMAs, square, sqrt, divide, axpy)."""
    if fused:
        return ComputeSpec(flops=12.0 * d, hbm_bytes=F32 * d * (4 + 3),
                           kernels=1)
    return ComputeSpec(flops=12.0 * d, hbm_bytes=F32 * d * (6 + 5),
                       kernels=5)


def ef_combine_cost(d: int) -> ComputeSpec:
    """The EF bookkeeping around an unfused compress: ``buf = x + err``
    (2 reads, 1 write) and ``new_err = buf - decompress(payload)`` (2
    reads, 1 write).  A fused EF kernel overrides ``compute_specs``
    wholesale instead."""
    return elementwise_pass(d, 2, 1) + elementwise_pass(d, 2, 1)


def combine_cost(d_total: int, n: int) -> ComputeSpec:
    """The all_to_all's local combine: the mean of ``n`` decompressed
    chunks (``d_total = n * chunk``), one pass reading every chunk and
    writing the combined one."""
    return ComputeSpec(flops=float(d_total),
                       hbm_bytes=F32 * (d_total + d_total // max(n, 1)),
                       kernels=1)


def ef_compress_cost(d: int, block: int) -> ComputeSpec:
    """``repro_ef_compress`` over ``d`` f32 elements: reads x and err,
    writes new_err, the d/8 packed bytes and one f32 scale a block."""
    return ComputeSpec(flops=4.0 * d,
                       hbm_bytes=3 * F32 * d + d // 8 + F32 * (d // block),
                       kernels=1)


def decompress_cost(d: int, block: int) -> ComputeSpec:
    """``repro_decompress`` of ``d`` elements: reads the payload, writes d
    f32."""
    return ComputeSpec(flops=2.0 * d,
                       hbm_bytes=F32 * d + d // 8 + F32 * (d // block),
                       kernels=1)


def attention_pairs(s: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs a length-``s`` self-attention mask lets through:
    s^2 unmasked; causal, key j <= query i; a window of w, also j > i - w
    (the masks of ``models.attention._causal_mask``)."""
    if not causal:
        return s * s if window is None else \
            sum(s - max(i - window + 1, 0) for i in range(s))
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention_cost(b: int, h: int, s: int, d: int, itemsize: int,
                         causal: bool = True, window=None) -> ComputeSpec:
    """One flash-attention launch on (B, H, S, D): q, k, v read and o
    written once; q.k and p.v, 2 D operations each, for every pair the
    mask lets through."""
    return ComputeSpec(flops=4.0 * b * h * d * attention_pairs(s, causal,
                                                                window),
                       hbm_bytes=4 * b * h * s * d * itemsize, kernels=1)


def lm_head_xent_cost(t: int, d: int, v_l: int, itemsize: int,
                      exact16: bool, backward: bool,
                      chunk_rows: int = 4096) -> ComputeSpec:
    """One call of the LM-head cross-entropy op on x (T, d) of
    ``itemsize`` bytes and w (d, V_l) f32.  ``exact16``: x is bf16 and
    enters its products as it is (three bf16 products for each f32 one);
    otherwise x is split too and each takes six.  The forward splits w
    (reads 4 d V_l bytes, writes 6) and reads x and the pieces once,
    writing three T-length vectors; the backward recomputes the logits,
    writes the logit gradient as three bf16 pieces a chunk of
    ``chunk_rows`` rows (6 T V_l bytes) that dX and dW read once each,
    and writes dX and dW, dW read again for every chunk after the first.
    """
    terms = 3 if exact16 else 6
    unit = 2.0 * t * d * v_l
    x_bytes = t * d * itemsize
    pieces = 6 * d * v_l
    if not backward:
        return ComputeSpec(flops=terms * unit,
                           hbm_bytes=x_bytes + F32 * d * v_l + 2 * pieces
                           + 3 * F32 * t,
                           kernels=2 if exact16 else 3)
    chunks = max(1, -(-t // chunk_rows))
    return ComputeSpec(flops=3 * terms * unit,
                       hbm_bytes=x_bytes + pieces + 4 * F32 * t
                       + 3 * 6 * t * v_l + F32 * t * d
                       + F32 * d * v_l * (2 * chunks - 1),
                       kernels=3 * chunks)


def moe_permute_cost(t: int, k: int, d: int, itemsize: int, filled: int,
                     tokens: int, backward: bool) -> ComputeSpec:
    """One ``moe_permute`` launch on rows of d ``itemsize``-byte elements:
    the forward reads the T k pair indices and each routed token's row
    once and writes the filled rows; the backward reads the T k slots and
    the filled rows and writes T rows, one add an element of a filled
    row."""
    if not backward:
        return ComputeSpec(hbm_bytes=4 * t * k + (tokens + filled) * d
                           * itemsize, kernels=1)
    return ComputeSpec(flops=float(filled * d),
                       hbm_bytes=4 * t * k + (filled + t) * d * itemsize,
                       kernels=1)


def moe_combine_cost(t: int, k: int, d: int, itemsize: int, filled: int,
                     tokens: int, backward: bool) -> ComputeSpec:
    """One ``moe_combine`` launch: the forward reads the T k slots and
    gates and the filled rows and writes T rows (a multiply and an add an
    element of a filled row); the backward reads the T k pair indices,
    the filled pairs' gates, the routed tokens' cotangent rows and the
    filled rows, and writes the filled rows' cotangents and their gates'
    (three operations an element of a filled row)."""
    if not backward:
        return ComputeSpec(flops=2.0 * filled * d,
                           hbm_bytes=8 * t * k + (filled + t) * d * itemsize,
                           kernels=1)
    return ComputeSpec(flops=3.0 * filled * d,
                       hbm_bytes=4 * t * k + 8 * filled
                       + (tokens + 2 * filled) * d * itemsize, kernels=1)
