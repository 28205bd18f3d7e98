"""Baseline Adam (BertAdam-style) on flat float32 vectors.

The port's copy of ``repro/core/adam.py``.  The paper's uncompressed
baseline disables bias correction (consistent with BertAdam / Devlin et
al. 2019); ``bias_correction=True`` restores Kingma-Ba.  Weight decay
follows BertAdam: ``update = m/(sqrt(v)+eps) + wd * x``.

Plain PyTorch on every device, as the reference computes it in plain jnp
outside any kernel: the registry's warmup stage, not this module, takes
the fused Adam kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = False


class AdamState(NamedTuple):
    m: torch.Tensor      # (D,) f32
    v: torch.Tensor      # (D,) f32
    count: torch.Tensor  # () i32


def init(d: int, device="cuda") -> AdamState:
    return AdamState(m=torch.zeros(d, dtype=torch.float32, device=device),
                     v=torch.zeros(d, dtype=torch.float32, device=device),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def moments(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
            count: torch.Tensor, x: torch.Tensor, b1: float, b2: float,
            eps: float, weight_decay: float, bias_correction: bool):
    """(m, v, update) of one Adam step in the reference's operation order
    (shared with ``core.onebit_adam.warmup_update``)."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * torch.square(g)
    if bias_correction:
        t = count.to(torch.float32)
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
    else:
        m_hat, v_hat = m, v
    upd = m_hat / (torch.sqrt(v_hat) + eps)
    if weight_decay:
        upd = upd + weight_decay * x
    return m, v, upd


def update(g: torch.Tensor, state: AdamState, x: torch.Tensor,
           cfg: AdamConfig, lr: float) -> Tuple[torch.Tensor, AdamState]:
    """One Adam step.  Returns (new_x, new_state).  ``g`` is the (already
    averaged) gradient; all f32 (D,)."""
    count = state.count + 1
    m, v, upd = moments(g, state.m, state.v, count, x, cfg.b1, cfg.b2,
                        cfg.eps, cfg.weight_decay, cfg.bias_correction)
    return x - lr * upd, AdamState(m=m, v=v, count=count)
