"""Public dispatch ops of the dropless expert layer, differentiable, the
device decides.

``permute(x, pair, slot, k)`` gathers x's rows into the routed buffer
(R = T * k rows, row r pair ``pair[r]`` or empty); its backward sums each
token's rows in choice order.  ``combine(ye, g, pair, slot, k)`` gives
y[t] = sum_j g[t, j] ye[slot[t, j]]; its backward gives the rows'
cotangents g dy[t] and the gates' <dy[t], ye[slot]>.  ``pair`` and
``slot`` are inverse maps (``models.mlp.route``), int32.

A CUDA tensor takes the kernels (``kernel.py``, called through the module
attribute, so a launch spy sees each launch), a CPU tensor the plain
version (``ref.py``); any other device raises.  An empty row of a
permuted buffer, or of the rows' cotangent, is zero on the CPU and left
unwritten on the card: no consumer reads it (the grouped expert products
cover the filled rows only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_dispatch import kernel as K
from repro_torch.kernels.moe_dispatch import ref as R


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no MoE dispatch path for device {t.device}")
    return t.device.type


class Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair, slot, k):
        ctx.k = k
        ctx.save_for_backward(slot)
        if _device(x) == "cuda":
            return K.moe_permute(x.contiguous(), pair, k)
        return R.permute(x, pair, k)

    @staticmethod
    def backward(ctx, dxp):
        (slot,) = ctx.saved_tensors
        if dxp.is_cuda:
            return K.moe_permute(dxp.contiguous(), slot, ctx.k,
                                 backward=True), None, None, None
        return R.permute_backward(dxp, slot), None, None, None


class Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, g, pair, slot, k):
        ctx.k = k
        ctx.save_for_backward(ye, g, pair)
        if _device(ye) == "cuda":
            return K.moe_combine(ye.contiguous(), g.contiguous(), slot, k)
        return R.combine(ye, g, slot)

    @staticmethod
    def backward(ctx, dy):
        ye, g, pair = ctx.saved_tensors
        if dy.is_cuda:
            dye, dg = K.moe_combine(ye.contiguous(), g.contiguous(), pair,
                                    ctx.k, dy=dy.contiguous())
        else:
            dye, dg = R.combine_backward(dy, ye, g, pair, ctx.k)
        return dye, dg, None, None, None


def permute(x: torch.Tensor, pair: torch.Tensor, slot: torch.Tensor,
            k: int) -> torch.Tensor:
    """(R, d) routed rows of x (T, d)."""
    return Permute.apply(x, pair, slot, k)


def combine(ye: torch.Tensor, g: torch.Tensor, pair: torch.Tensor,
            slot: torch.Tensor, k: int) -> torch.Tensor:
    """(T, d): the gated sum of each token's rows of ye (R, d)."""
    return Combine.apply(ye, g, pair, slot, k)
