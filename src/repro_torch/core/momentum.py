"""Momentum SGD variants used as baselines in the paper's experiments.

The port's copy of ``repro/core/momentum.py``:

  * momentum SGD (paper Sec. 7.2 baseline)
  * EF momentum SGD (Zheng et al. 2019; paper supplementary Fig. 11) —
    1-bit-compressed momentum with error feedback, no Adam precondition
  * naive compressed Adam (paper Fig. 1 / Sec. 3.2) — EF-compressed
    *gradient* feeding full Adam with a live (non-frozen) variance; this is
    the strategy the paper shows fails.

All on flat float32 vectors, same conventions as ``onebit_adam``.  The
exchange is the port's ``core.comm.compressed_allreduce``: on CUDA
tensors its 1-bit compressor takes the ``ef_compress`` and
``decompress`` kernels.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import comm
from repro_torch.core.compression import CompressionConfig
from repro_torch.optim.compressors import as_compressor


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=device)


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class MomentumConfig:
    beta: float = 0.9
    weight_decay: float = 0.0
    compression: CompressionConfig = CompressionConfig(kind="identity")


class MomentumState(NamedTuple):
    m: torch.Tensor
    worker_err: torch.Tensor
    server_err: torch.Tensor
    count: torch.Tensor


def init(d: int, n_dp: int, device="cuda") -> MomentumState:
    n = max(n_dp, 1)
    return MomentumState(m=_zeros(d, device), worker_err=_zeros(d, device),
                         server_err=_zeros(d // n, device),
                         count=_count(device))


def update(g_local: torch.Tensor, state: MomentumState, x: torch.Tensor,
           cfg: MomentumConfig, lr: float, dp_axes: Sequence[str] = ()
           ) -> Tuple[torch.Tensor, MomentumState]:
    """EF-compressed momentum SGD (identity compression = plain momentum)."""
    m_local = cfg.beta * state.m + (1.0 - cfg.beta) * g_local
    m_bar, w_err, s_err = comm.compressed_allreduce(
        m_local, state.worker_err, state.server_err, dp_axes,
        as_compressor(cfg.compression))
    upd = m_bar + cfg.weight_decay * x if cfg.weight_decay else m_bar
    return x - lr * upd, state._replace(m=m_bar, worker_err=w_err,
                                        server_err=s_err,
                                        count=state.count + 1)


class NaiveCompressedAdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    worker_err: torch.Tensor
    server_err: torch.Tensor
    count: torch.Tensor


def naive_init(d: int, n_dp: int, device="cuda"
               ) -> NaiveCompressedAdamState:
    n = max(n_dp, 1)
    return NaiveCompressedAdamState(
        m=_zeros(d, device), v=_zeros(d, device),
        worker_err=_zeros(d, device), server_err=_zeros(d // n, device),
        count=_count(device))


def naive_compressed_adam_update(
        g_local: torch.Tensor, state: NaiveCompressedAdamState,
        x: torch.Tensor, b1: float, b2: float, eps: float, lr: float,
        compression: CompressionConfig, dp_axes: Sequence[str] = ()
) -> Tuple[torch.Tensor, NaiveCompressedAdamState]:
    """The strategy the paper shows does NOT converge (Fig. 1): compress the
    gradient with EF and update both m and v from the compressed gradient."""
    g_bar, w_err, s_err = comm.compressed_allreduce(
        g_local, state.worker_err, state.server_err, dp_axes,
        as_compressor(compression))
    m = b1 * state.m + (1.0 - b1) * g_bar
    v = b2 * state.v + (1.0 - b2) * torch.square(g_bar)
    new_x = x - lr * m / (torch.sqrt(v) + eps)
    return new_x, state._replace(m=m, v=v, worker_err=w_err,
                                 server_err=s_err, count=state.count + 1)
