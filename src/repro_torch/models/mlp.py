"""Feed-forward layer of the BERT encoder (gelu); SwiGLU and MoE are
later slices."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense


def mlp_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_kind != "gelu":
        raise NotImplementedError(f"mlp_kind {cfg.mlp_kind!r} is not "
                                  "ported yet (ROADMAP Queue 1)")
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(x, p["wg"]), approximate="tanh")
    return dense(h, p["wd"])
