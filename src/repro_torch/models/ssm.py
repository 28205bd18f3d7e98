"""Mamba-1 selective-SSM block, as ``repro/models/ssm.py``: the training /
prefill forward and the one-token decode against its state.

Parameters (d = d_model, di = d_inner, N = ssm_state, R = dt_rank):
  in_proj_x, in_proj_z (d, di)   the x and gate projections (separate leaves)
  conv_w    (ssm_conv, di)       depthwise causal conv
  x_proj    (di, R + 2N)         -> (dt_lowrank, B, C)
  dt_proj   (R, di), dt_bias (di,)
  A_log     (di, N), D (di,)
  out_proj  (di, d)

The selective scan is a loop over the sequence, in f32:
``h = exp(dt * A) * h + (dt * x) * B``, ``y = h . C``; then ``y + x * D``,
gated by ``silu(z)``.  The decay ``exp(dt * A)`` and the input ``(dt * x)
* B`` of every timestep are elementwise and computed before the loop, so
each step of the loop is one fused multiply-add.

Tensor parallelism (training and serving) splits d_inner over
the model ranks: in_proj_x / in_proj_z, conv_w, dt_proj, dt_bias, A_log
and D are this rank's channels; x_proj is row-parallel, closed by an
``f_reduce`` so that (dt_lowrank, B, C) are whole on every rank, then
``g_copy``'d into the rank's own channels; out_proj is row-parallel.  The
scan is local: a rank's state is (B, di / tp, N).

The decode state of a sequence is ``{"h": (B, di, N) f32, "conv": (B, K-1,
di)}``: the scan's last state and the last K-1 raw (pre-conv) inputs.
``ssm_forward(return_state=True)`` (the prefill) returns it beside the
output; there the scan runs :data:`SCAN_CHUNK` timesteps at a time, so
that only one chunk's decay, drive and states are held at once (a prefill
needs the final state and each step's output, not every state).
``decode_ssm`` advances it by one token in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (NO_TP, ParallelCtx, dense, f_reduce,
                                       g_copy)


# the leaves whose initialisation is not N(0, 1/d_in)
SPECIAL_LEAVES = ("A_log", "D", "conv_w", "dt_bias")
# the leaves the reference reads in f32 whatever the compute dtype
F32_LEAVES = ("A_log", "D", "dt_bias")
# timesteps the prefill's scan materialises at once
SCAN_CHUNK = 256
# the dim of each leaf split over the model axis
SSM_SPECS = {"in_proj_x": 1, "in_proj_z": 1, "conv_w": 1, "x_proj": 0,
             "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}


def init_leaf(leaf: str, shape, generator: torch.Generator) -> torch.Tensor:
    """One of :data:`SPECIAL_LEAVES` at ``shape`` (its leading axes are
    the stacked superblocks), with the reference's distribution: A_log =
    log(1..N) on every channel, D = 1, conv_w N(0, 0.1^2), dt_bias the
    inverse softplus of a log-uniform draw in [1e-3, 1e-1] (so that
    softplus(dt) starts in that range).  The others (the projections,
    dt_proj at R^-0.5) are N(0, 1/d_in)."""
    dev = generator.device
    if leaf == "A_log":
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev)
        return torch.log(a).expand(shape).contiguous()
    if leaf == "D":
        return torch.ones(shape, device=dev)
    if leaf == "conv_w":
        return torch.randn(shape, generator=generator, device=dev) * 0.1
    if leaf == "dt_bias":
        u = torch.rand(shape, generator=generator, device=dev)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    raise KeyError(leaf)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out


def _ssm_params(p, x_in: torch.Tensor, cfg: ArchConfig,
                ctx: ParallelCtx = NO_TP):
    """x_in (B, S, di) -> dt (B, S, di) f32, B and C (B, S, N) f32, and
    A = -exp(A_log) (di, N) (di: this rank's channels)."""
    n, dtr = cfg.ssm_state, cfg.dt_rank
    dbc = g_copy(f_reduce(dense(x_in, p["x_proj"]), ctx), ctx)
    dt_low, b_mat, c_mat = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = dense(dt_low, p["dt_proj"])
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    return dt, b_mat.to(torch.float32), c_mat.to(torch.float32), a


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor,
                   chunk: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[t] = h[t] . C[t], h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t] B[t],
    h[-1] = 0.  x, dt: (B, S, di); a: (di, N); B, C: (B, S, N); f32.

    ``chunk``: the timesteps whose decay, drive and states are
    materialised at once (None: the whole sequence, as training's
    backward keeps every state anyway).  Returns y (B, S, di) and the last
    state h[S-1] (B, di, N)."""
    s = x.shape[1]
    step = s if chunk is None else chunk
    h = torch.zeros(x.shape[0], x.shape[2], a.shape[-1], dtype=x.dtype,
                    device=x.device)
    ys = []
    for t0 in range(0, s, step):
        if step < s:            # (no slice, so no slice backward, else)
            sl = slice(t0, t0 + step)
            xc, dtc, bc, cc = x[:, sl], dt[:, sl], b_mat[:, sl], c_mat[:, sl]
        else:
            xc, dtc, bc, cc = x, dt, b_mat, c_mat
        decay = torch.exp(dtc[..., None] * a)                 # (B, s, di, N)
        drive = (dtc * xc)[..., None] * bc[:, :, None, :]     # (B, s, di, N)
        # unbind once: backward stacks the timesteps' gradients in one op
        # (indexing each timestep would make each backward step write a
        # zero-filled full-size gradient)
        hs = []
        for dec, drv in zip(decay.unbind(1), drive.unbind(1)):
            h = torch.addcmul(drv, dec, h)
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), cc))
        del decay, drive, hs        # before the next chunk's are made
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def ssm_forward(p, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False, ctx: ParallelCtx = NO_TP,
                outer: str = "tp"):
    """Training / prefill forward. x: (B, S, d) -> (B, S, d).

    ``return_state=True`` also returns the decode state ``{"h", "conv"}``
    after the sequence (the prefill; it needs S >= ssm_conv - 1, the
    length of the conv tail).  ``outer="none"`` (sequence parallelism): x
    already gathered, the output this rank's partial sum."""
    dt_ = x.dtype
    s, k = x.shape[1], cfg.ssm_conv
    if return_state and s < k - 1:
        raise ValueError(f"a prefill of {s} tokens is shorter than the conv "
                         f"tail of {k - 1}")
    xin = x if outer == "none" else g_copy(x, ctx)
    xraw = dense(xin, p["in_proj_x"])                      # (B, S, di)
    z = dense(xin, p["in_proj_z"])
    xi = F.silu(_causal_conv(xraw, p["conv_w"].to(dt_)))
    dt, b_mat, c_mat, a = _ssm_params(p, xi, cfg, ctx)
    xf = xi.to(torch.float32)
    y, h = selective_scan(xf, dt, a, b_mat, c_mat,
                          SCAN_CHUNK if return_state else None)
    y = (y + xf * p["D"]).to(dt_) * F.silu(z)
    out = dense(y, p["out_proj"])
    if outer != "none":
        out = f_reduce(out, ctx)
    if return_state:
        return out, {"h": h, "conv": xraw[:, s - (k - 1):]}
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cpu", tp: int = 1) -> Dict[str, torch.Tensor]:
    """Zero decode state of one layer: h (B, di, N) f32, the conv tail
    (B, K-1, di) in ``dtype`` (global shapes: at ``tp`` each model rank
    holds di / tp of the channels)."""
    if cfg.d_inner % tp:
        raise ValueError(f"d_inner {cfg.d_inner} does not split over {tp} "
                         "model ranks")
    di = cfg.d_inner
    return {"h": torch.zeros(batch, di, cfg.ssm_state, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, cfg.ssm_conv - 1, di, dtype=dtype,
                                device=device)}


def decode_ssm(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ArchConfig, ctx: ParallelCtx = NO_TP) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); ``cache`` h (B, di, N), conv tail
    (B, K-1, di) (di: this rank's channels under ``ctx``).  Advances
    ``cache`` in place (each leaf in its own dtype) and returns the layer
    output (B, 1, d)."""
    dt_ = x.dtype
    xin = g_copy(x, ctx)
    xi = dense(xin[:, 0, :], p["in_proj_x"])               # (B, di)
    z = dense(xin[:, 0, :], p["in_proj_z"])
    # the conv over [tail, x], in the wider of the two dtypes
    hist = torch.cat([cache["conv"], xi[:, None, :]], dim=1)
    w = p["conv_w"].to(dt_).to(hist.dtype)                 # (K, di)
    xi_c = F.silu(torch.einsum("bkc,kc->bc", hist, w))
    dt, b_mat, c_mat, a = _ssm_params(p, xi_c[:, None, :], cfg, ctx)
    dtt, bt, ct = dt[:, 0], b_mat[:, 0], c_mat[:, 0]
    xf = xi_c.to(torch.float32)
    h = torch.exp(dtt[..., None] * a) * cache["h"] \
        + (dtt * xf)[..., None] * bt[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, ct) + xf * p["D"]
    y = y.to(dt_) * F.silu(z)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return f_reduce(dense(y, p["out_proj"]), ctx)[:, None, :]
