"""Mamba-1 selective-SSM block at tp=1, the training forward of
``repro/models/ssm.py``.

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
each step of the loop is one fused multiply-add.  The reference's
``f_reduce`` / ``g_copy`` collectives are identities at tp = 1; its
decode state (``return_state``, ``init_ssm_cache``, ``decode_ssm``)
belongs to serving, not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense


# the leaves whose initialisation is not N(0, 1/d_in)
SPECIAL_LEAVES = ("A_log", "D", "conv_w", "dt_bias")


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


def _ssm_params(p, x_in: torch.Tensor, cfg: ArchConfig):
    """x_in (B, S, di) -> dt (B, S, di) f32, B and C (B, S, N) f32, and
    A = -exp(A_log) (di, N)."""
    n, dtr = cfg.ssm_state, cfg.dt_rank
    dbc = dense(x_in, p["x_proj"])
    dt_low, b_mat, c_mat = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = dense(dt_low, p["dt_proj"])
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    return dt, b_mat.to(torch.float32), c_mat.to(torch.float32), a


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor) -> torch.Tensor:
    """y[t] = h[t] . C[t], h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t] B[t],
    h[-1] = 0.  x, dt: (B, S, di); a: (di, N); B, C: (B, S, N); f32."""
    decay = torch.exp(dt[..., None] * a)                  # (B, S, di, N)
    drive = (dt * x)[..., None] * b_mat[:, :, None, :]    # (B, S, di, N)
    # unbind once: backward stacks the timesteps' gradients in one op
    # (indexing each timestep would make each backward step write a
    # zero-filled full-size gradient)
    h = torch.zeros_like(drive[:, 0])
    hs = []
    for dec, drv in zip(decay.unbind(1), drive.unbind(1)):
        h = torch.addcmul(drv, dec, h)
        hs.append(h)
    return torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), c_mat)


def ssm_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Training forward. x: (B, S, d) -> (B, S, d)."""
    dt_ = x.dtype
    xraw = dense(x, p["in_proj_x"])                        # (B, S, di)
    z = dense(x, p["in_proj_z"])
    xi = F.silu(_causal_conv(xraw, p["conv_w"].to(dt_)))
    dt, b_mat, c_mat, a = _ssm_params(p, xi, cfg)
    xf = xi.to(torch.float32)
    y = selective_scan(xf, dt, a, b_mat, c_mat) + xf * p["D"]
    y = y.to(dt_) * F.silu(z)
    return dense(y, p["out_proj"])
