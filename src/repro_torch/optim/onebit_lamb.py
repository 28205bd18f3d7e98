"""1-bit LAMB (arXiv:2104.06069) — large-batch layerwise scaling, 1-bit.

LAMB rescales each layer's Adam direction by the trust ratio
``||x_l|| / ||u_l||`` so very large batches keep a usable step size.
Computing that ratio from compressed momenta is the trap the 1-bit Adam
paper describes for ``v``: the quantisation noise corrupts the norm.
1-bit LAMB runs true LAMB while communication is uncompressed, then
**freezes the layerwise ratios** at the stage switch and keeps using them
through the compression stage.

Segments come from the ``ravel_pytree`` leaf order (a
:class:`repro_torch.optim.base.SegmentInfo` from the train step), the zero
padding in its own trailing segment; under zero1 the squared sums are
summed over dp, so the frozen ratios are global layer norms.

The freeze is state-carried: ``scale`` starts at zero (sentinel), and the
first compression-stage step writes the clipped live ratio into every
still-zero slot; afterwards the stored value wins, so a checkpoint
resumes with the exact frozen ratios.

The port's copy of ``repro/optim/onebit_lamb.py``, audit hook included
(the frozen ratios as the ``scale_seg`` stat of ``repro_torch.obs.audit``).
Without segment info every hook is the identity, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.base import (TwoStageOptimizer, register_optimizer,
                                    segment_norms)


@register_optimizer("onebit_lamb")
@dataclasses.dataclass(frozen=True)
class OneBitLamb(TwoStageOptimizer):
    min_ratio: float = 0.05     # trust-ratio clip (stability; also keeps
    max_ratio: float = 10.0     # the frozen values > 0, see sentinel)

    name: str = "onebit_lamb"

    def _trust_ratio(self, x, upd, segs, norm_axes):
        xn = segment_norms(x, segs, norm_axes)
        un = segment_norms(upd, segs, norm_axes)
        r = torch.where((xn > 0.0) & (un > 0.0),
                        xn / torch.clamp(un, min=1e-12),
                        torch.ones_like(xn))
        return torch.clamp(r, self.min_ratio, self.max_ratio)

    def _warmup_direction(self, upd, x, segs, norm_axes):
        if segs is None:
            return upd  # no segment info: plain Adam warmup
        return upd * segs.expand(self._trust_ratio(x, upd, segs, norm_axes))

    def _update_scale(self, scale, x, upd, segs, norm_axes):
        if segs is None:
            return scale
        live = self._trust_ratio(x, upd, segs, norm_axes)
        # freeze-on-first-use: zero slots take the live ratio once; the
        # clip keeps stored ratios >= min_ratio > 0, so they never rewrite
        return torch.where(scale > 0.0, scale, live)

    def _scale_per_elem(self, scale, segs):
        if segs is None:
            return None
        return segs.expand(scale)

    # the audit probe also surfaces the frozen layerwise trust ratios: a
    # ratio pinned at the clip bounds, or a still-zero sentinel deep into
    # the compression stage, is the per-segment pathology the fidelity
    # event should show
    @property
    def audit_extra_keys(self):
        return ("scale_seg",)

    def _audit_extra(self, state, segs):
        return {"scale_seg": state.scale}
