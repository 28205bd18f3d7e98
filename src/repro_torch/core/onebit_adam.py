"""1-bit Adam (Algorithm 1 of the paper), on flat float32 vectors.

The port's copy of ``repro/core/onebit_adam.py``: the algorithm written as
plain functions, an implementation independent of the registry optimizer
(``repro_torch.optim.onebit_adam``) that the benchmarks drive and the
tests and ``chip_smoke.py`` hold the registry to.

Two-stage optimizer:
  * warmup stage  — vanilla (Bert)Adam on the dp-averaged gradient, while
    tracking the second moment ``v`` (plain PyTorch on every device);
  * compression stage — ``v`` frozen at the switch step; local momentum is
    updated with the *local* (unaveraged) gradient and reduced across dp via
    the error-compensated 1-bit ``compressed_allreduce`` (on CUDA tensors:
    the ``ef_compress`` and ``decompress`` kernels); the model update is
    momentum SGD preconditioned by ``1/(sqrt(v_frozen)+eps)``.

State layout (one process is one dp rank):
  m, v       (D,)   replicated over dp
  worker_err (D,)   per-dp-rank (Alg. 1 delta^(i))
  server_err (D/n,) per-dp-rank, rank i is the "server" of chunk i (delta-bar)

``hierarchical=True`` with ``pod_axes`` raises ``NotImplementedError``:
the reference's branch (``src/repro/core/onebit_adam.py:108``) passes
``inner_axes`` both by position and by keyword and raises ``TypeError``,
so it has no behaviour to port.  Without ``pod_axes`` the reference never
reaches that branch, and neither does the port: it takes the flat path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import comm
from repro_torch.core.adam import moments
from repro_torch.core.compression import CompressionConfig
from repro_torch.optim.compressors import as_compressor
from repro_torch.plan.executor import all_gather_into, group_of


@dataclasses.dataclass(frozen=True)
class OneBitAdamConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = False       # BertAdam disables it (paper setup)
    compression: CompressionConfig = CompressionConfig()
    hierarchical: bool = False          # beyond-paper two-level allreduce
    # auto-warmup rule (paper Sec. 7.1): freeze once
    # ||v_t||_1 / ||v_{t-Delta}||_1 >= threshold, Delta = 1/(1-b2),
    # and never before LR warmup ends.
    var_freeze_threshold: float = 0.96


class OneBitAdamState(NamedTuple):
    m: torch.Tensor           # (D,) f32, the server momentum m-bar
    v: torch.Tensor           # (D,) f32, second moment (frozen after warmup)
    worker_err: torch.Tensor  # (D,) f32, this dp-rank's worker error
    server_err: torch.Tensor  # (D/n_dp,) f32, this rank's server-chunk error
    count: torch.Tensor       # () i32


def init(d: int, n_dp: int, device="cuda") -> OneBitAdamState:
    n = max(n_dp, 1)
    if d % n:
        raise ValueError(f"d={d} does not split over {n_dp} dp ranks")

    def zeros(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    return OneBitAdamState(
        m=zeros(d), v=zeros(d), worker_err=zeros(d),
        server_err=zeros(d // n),
        count=torch.zeros((), dtype=torch.int32, device=device))


def warmup_update(g_local: torch.Tensor, state: OneBitAdamState,
                  x: torch.Tensor, cfg: OneBitAdamConfig, lr: float,
                  dp_axes: Sequence[str] = ()
                  ) -> Tuple[torch.Tensor, OneBitAdamState, dict]:
    """Warmup stage: uncompressed Adam on the dp-mean gradient."""
    g = comm.allreduce_mean(g_local, dp_axes)
    count = state.count + 1
    m, v, upd = moments(g, state.m, state.v, count, x, cfg.b1, cfg.b2,
                        cfg.eps, cfg.weight_decay, cfg.bias_correction)
    new_x = x - lr * upd
    stats = {"v_l1": torch.sum(torch.abs(v)),
             "grad_norm": torch.linalg.vector_norm(g)}
    return new_x, state._replace(m=m, v=v, count=count), stats


def compressed_update(g_local: torch.Tensor, state: OneBitAdamState,
                      x: torch.Tensor, cfg: OneBitAdamConfig, lr: float,
                      dp_axes: Sequence[str] = (),
                      pod_axes: Sequence[str] = ()
                      ) -> Tuple[torch.Tensor, OneBitAdamState, dict]:
    """Compression stage (Alg. 1 lines 4-13). ``v`` is frozen.

    dp_axes: all data-parallel axes; pod_axes: the cross-pod axes, which
    the flat exchange spans after ``dp_axes`` (with ``hierarchical``
    they raise, see the module doc)."""
    if cfg.hierarchical and pod_axes:
        raise NotImplementedError(
            "OneBitAdamConfig(hierarchical=True) with pod_axes: the "
            "reference's branch at src/repro/core/onebit_adam.py:108 passes "
            "inner_axes twice to compressed_allreduce_hierarchical and "
            "raises TypeError, so there is no behaviour to port; the "
            "registry optimizers run the hierarchical exchange "
            "(repro_torch.optim, pod_axes)")
    # Alg. 1 line 6 — local momentum from the *local* gradient.
    m_local = cfg.b1 * state.m + (1.0 - cfg.b1) * g_local
    m_bar, w_err, s_err = comm.compressed_allreduce(
        m_local, state.worker_err, state.server_err,
        tuple(dp_axes) + tuple(pod_axes), as_compressor(cfg.compression))
    del m_local
    # Alg. 1 line 13 — preconditioned momentum SGD update.
    upd = m_bar / (torch.sqrt(state.v) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * x
    new_x = x - lr * upd
    stats = {
        "v_l1": torch.sum(torch.abs(state.v)),
        "momentum_norm": torch.linalg.vector_norm(m_bar),
        "worker_err_norm": torch.linalg.vector_norm(w_err),
        "server_err_norm": torch.linalg.vector_norm(s_err),
    }
    new_state = state._replace(m=m_bar, worker_err=w_err, server_err=s_err,
                               count=state.count + 1)
    return new_x, new_state, stats


class ZeroOneBitAdamState(NamedTuple):
    """dp-sharded (ZeRO-1-style) compression-stage state (beyond-paper).

    ``m`` and ``worker_err`` stay full (Alg. 1 needs them per worker);
    the frozen ``v`` and the f32 master weights shard over dp (rank i owns
    chunk i), and the updated bf16 replica is rebuilt with one
    all_gather."""
    m: torch.Tensor             # (D,)   f32
    v_shard: torch.Tensor       # (D/n,) f32, this rank's frozen-v chunk
    master_shard: torch.Tensor  # (D/n,) f32, this rank's master weights
    worker_err: torch.Tensor    # (D,)   f32
    server_err: torch.Tensor    # (D/n,) f32
    count: torch.Tensor


def zero1_compressed_update(g_local: torch.Tensor,
                            state: ZeroOneBitAdamState,
                            cfg: OneBitAdamConfig, lr: float,
                            dp_axes: Sequence[str] = ()
                            ) -> Tuple[torch.Tensor, ZeroOneBitAdamState,
                                       dict]:
    """ZeRO-1 composed compression stage.  Returns (new bf16 full params
    flat, new state, stats).  ``g_local`` is the bf16-compute gradient
    cast to f32 by the caller."""
    m_local = cfg.b1 * state.m + (1.0 - cfg.b1) * g_local
    m_bar, w_err, s_err = comm.compressed_allreduce(
        m_local, state.worker_err, state.server_err, dp_axes,
        as_compressor(cfg.compression))
    del m_local
    n = comm.axis_size(dp_axes)
    chunk = m_bar.shape[0] // max(n, 1)
    lo = comm.axis_index(dp_axes) * chunk
    my_mbar = m_bar[lo:lo + chunk]
    upd = my_mbar / (torch.sqrt(state.v_shard) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * state.master_shard
    new_master = state.master_shard - lr * upd
    shard = new_master.to(torch.bfloat16)
    if dp_axes:
        # jax.lax.all_gather(..., tiled=True): the chunks in rank order
        x_full = torch.empty(n * chunk, dtype=torch.bfloat16,
                             device=shard.device)
        all_gather_into(x_full, shard, group=group_of(dp_axes))
    else:
        x_full = shard
    stats = {"v_l1": torch.sum(torch.abs(state.v_shard)),
             "momentum_norm": torch.linalg.vector_norm(m_bar)}
    new_state = state._replace(m=m_bar, master_shard=new_master,
                               worker_err=w_err, server_err=s_err,
                               count=state.count + 1)
    return x_full, new_state, stats
