"""Feed-forward layer at tp=1: gelu (the BERT encoder) and SwiGLU (the
dense decoders), as ``repro/models/mlp.py:mlp_forward``.  MoE is a later
slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["wg"]), approximate="tanh")
    elif cfg.mlp_kind == "swiglu":
        h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
    else:
        raise ValueError(f"unknown mlp_kind {cfg.mlp_kind!r}")
    return dense(h, p["wd"])
