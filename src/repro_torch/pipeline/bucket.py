"""Bucketer — partition a flat exchange vector into compressor-aligned
buckets.

A bucket is a contiguous slice of the padded flat exchange vector that
runs the whole collective schedule on its own.  Its size is a multiple of
the *alignment unit* ``align = n_total * block_size``, so that

  * every compressor block falls inside one bucket (per-block compression
    of a bucket is then bitwise that of the full vector — what makes the
    pipelined executor bitwise the serial one);
  * every all_to_all / all_gather chunk boundary inside the bucket is
    block-aligned too (``d_bucket % n == 0`` for every group size ``n``
    dividing ``n_total``), so the per-bucket sub-plans validate.

Size policy: the ``d // align`` alignment units are split as evenly as
possible over ``n_buckets``; the remainder goes to the trailing buckets
(the leading buckets are the small ones: the pipeline fills sooner).
Asking for more buckets than there are units clamps to one unit a bucket;
``n_buckets=1`` is the serial plan.

The port's copy of ``repro/pipeline/bucket.py``; its assertions raise
``ValueError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Bucketer:
    """Frozen bucket partition of a ``d``-element flat exchange."""

    d: int
    align: int
    sizes: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)

    def validate(self) -> "Bucketer":
        if self.d < 1 or self.align < 1 or self.d % self.align \
                or sum(self.sizes) != self.d \
                or any(s < self.align or s % self.align
                       for s in self.sizes):
            raise ValueError(f"invalid bucket partition {self}")
        return self

    @classmethod
    def build(cls, d: int, n_buckets: int, align: int) -> "Bucketer":
        """Evenly split ``d`` into up to ``n_buckets`` aligned buckets (see
        the module docstring)."""
        if d < 1 or align < 1 or n_buckets < 1:
            raise ValueError(f"bucketer: d={d}, align={align}, "
                             f"n_buckets={n_buckets}")
        if d % align:
            raise ValueError(
                f"bucketed exchange needs d ({d}) divisible by the "
                f"alignment unit n_total*block ({align})")
        units = d // align
        n = min(n_buckets, units)
        base, rem = divmod(units, n)
        # leading (n - rem) buckets get `base` units, trailing get base+1
        sizes = tuple(base * align for _ in range(n - rem)) + \
            tuple((base + 1) * align for _ in range(rem))
        return cls(d=d, align=align, sizes=sizes).validate()

    @classmethod
    def for_exchange(cls, d: int, n_total: int, block_size: int,
                     n_buckets: int) -> "Bucketer":
        """The alignment of an optimizer exchange: every bucket a multiple
        of ``n_total * block_size`` (``padded_length`` makes ``d`` one)."""
        return cls.build(d, n_buckets, max(n_total, 1) * max(block_size, 1))
