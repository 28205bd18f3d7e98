"""Public LM-head cross-entropy op: the per-row statistics of this rank's
vocab shard, differentiable, the device decides.

``lm_head_xent(x, w, labels, off, vocab)`` gives, for each row of x
(..., d) against w (d, V_l), this rank's columns ``off .. off + V_l`` of
the vocab:

* ``m_l``: the max of the f32 logits, the columns at or past ``vocab``
  masked to -1e30 (no gradient: the caller's global max is detached);
* ``s_l``: the sum of ``exp(logit - m_l)``;
* ``ll_l``: the label's logit, 0 where the label lies on another shard.

Its backward takes the cotangents of ``s_l`` and ``ll_l``.  A CUDA tensor
takes the Hopper kernels (``kernel.py``), which never hold the T x V_l
logits; a CPU tensor the plain version (``ref.py``); a meta tensor (the
dry run) empty outputs and one stand-in launch a direction, priced by
``perf.kernel_cost.lm_head_xent_cost``.  Any other device raises.  Each
call on the card counts one ``lm_head_xent_fwd`` or ``lm_head_xent_bwd``
in ``build.launch_counts()`` (``kernel.py`` counts them).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lm_head_xent import kernel as K
from repro_torch.kernels.lm_head_xent import ref as R
from repro_torch.perf import kernel_cost


def _cost(x: torch.Tensor, v_l: int, backward: bool):
    t, d = x.shape
    return kernel_cost.lm_head_xent_cost(
        t, d, v_l, x.element_size(), x.dtype == torch.bfloat16, backward,
        K.CHUNK_ROWS)


class LMHeadXent(torch.autograd.Function):
    """(m_l, s_l, ll_l) of x (T, d) and w (d, V_l); ``lab`` (T,) int32 is
    the label's local column or -1, ``n_keep`` the local columns below the
    padded vocab."""

    @staticmethod
    def forward(ctx, x, w, lab, n_keep):
        ctx.n_keep, ctx.device = n_keep, x.device.type
        ctx.x_shape, ctx.x_dtype, ctx.w_shape = x.shape, x.dtype, w.shape
        if x.is_meta:
            build.meta_launch("lm_head_xent_fwd", _cost(x, w.shape[1], False))
            m, s, ll = (x.new_empty(x.shape[0], dtype=torch.float32)
                        for _ in range(3))
        elif x.is_cuda:
            m, s, ll, ctx.saved = K.forward(x, w, lab, n_keep)
            ctx.save_for_backward(lab, m)
        elif x.device.type == "cpu":
            m, s, ll = R.forward(x, w, lab, n_keep)
            ctx.save_for_backward(x, w, lab, m)
        else:
            raise ValueError(f"no LM-head cross-entropy path for device "
                             f"{x.device}")
        ctx.mark_non_differentiable(m)
        return m, s, ll

    @staticmethod
    def backward(ctx, _gm, gs, gll):
        if ctx.device == "meta":
            x = torch.empty(ctx.x_shape, dtype=ctx.x_dtype, device="meta")
            build.meta_launch("lm_head_xent_bwd",
                              _cost(x, ctx.w_shape[1], True))
            return x, torch.empty(ctx.w_shape, device="meta"), None, None
        if ctx.device == "cuda":
            lab, m = ctx.saved_tensors
            dx, dw = K.backward(ctx.saved, lab, ctx.n_keep, m, gs.float(),
                                gll.float(), ctx.x_shape[1])
        else:
            x, w, lab, m = ctx.saved_tensors
            dx, dw = R.backward(x, w, lab, ctx.n_keep, m, gs, gll)
        return dx.to(ctx.x_dtype), dw, None, None


def lm_head_xent(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 off: int, vocab: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m_l, s_l, ll_l), each shaped like ``labels``, of x (..., d) and
    this rank's head columns w (d, V_l) at global offset ``off``; the
    global columns at or past ``vocab`` are masked."""
    d, v_l = w.shape
    local = labels.reshape(-1).long() - off
    lab = torch.where((local >= 0) & (local < v_l), local,
                      -1).to(torch.int32)
    n_keep = min(max(vocab - off, 0), v_l)
    outs = LMHeadXent.apply(x.reshape(-1, d), w, lab, n_keep)
    return tuple(o.view(labels.shape) for o in outs)
