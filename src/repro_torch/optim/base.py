"""Two-stage compressed-optimizer interface and registry.

Every optimizer of the family shares one shape of algorithm:

  * **warmup stage** — an uncompressed adaptive step on the dp-mean
    gradient while the second moment ``v`` is tracked;
  * **compression stage** — ``v`` frozen, the local momentum reduced across
    dp by the error-compensated compressed allreduce, the model updated by
    preconditioned momentum SGD.

The base class is exactly 1-bit Adam (Alg. 1).  Slice 1 ports the
replicated state layout; the ``local``/``zero1`` layouts, the ``sync=False``
steps and the per-bucket gradient parts of the reference are later slices.

The port updates nothing in place: like the reference, both stages return
the new parameter vector and a new state tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.kernels.fused_adam import ops as _fused_adam
from repro_torch.optim.compressors import Compressor, OneBitCompressor
from repro_torch.state.slots import (SlotSpec, StateLayout, StateTree,
                                     ef_errs, init_rank_state)

# every update path emits this same stat set: the paper's fused-variance L1
# norm (Fig. 2), the grad/momentum L2 norms, and the two EF-residual norms
STAT_KEYS = ("v_l1", "grad_norm", "momentum_norm", "worker_err_norm",
             "server_err_norm")


def _f32(a) -> float:
    """The f32 value a Python scalar takes when it meets an f32 array."""
    return float(np.float32(a))


@dataclasses.dataclass(frozen=True)
class TwoStageOptimizer:
    """Base: exactly 1-bit Adam (Alg. 1)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = False       # BertAdam disables it (paper setup)
    compressor: Compressor = OneBitCompressor()

    name: str = "?"

    # --- declared state ----------------------------------------------------
    def state_slots(self, layout: str = "replicated"
                    ) -> Tuple[SlotSpec, ...]:
        """The family's state, declared once (the replicated layout)."""
        if layout != "replicated":
            raise NotImplementedError(f"layout {layout!r} is not ported yet")
        return (
            SlotSpec("m"),
            SlotSpec("v"),
            SlotSpec("worker_err", "per_param", "per_dp_rank", ef="worker"),
            SlotSpec("server_err", "per_chunk", "per_dp_rank", ef="server"),
            SlotSpec("scale", "per_segment"),
            SlotSpec("count", "scalar", dtype="int32"),
            SlotSpec("v_step", "scalar", dtype="int32"),
        )

    def init_state(self, d: int, n_dp: int = 1, n_segments: int = 1,
                   device="cpu") -> StateTree:
        """Zeros per-rank state for a ``d``-element exchange over ``n_dp``
        ranks."""
        ctx = StateLayout(d=d, n_dp=max(n_dp, 1),
                          n_segments=max(n_segments, 1))
        return init_rank_state(self.state_slots(), ctx, device)

    @staticmethod
    def _stats(v_l1, grad_norm, momentum_norm, state=None,
               worker_err=None, server_err=None) -> Dict[str, torch.Tensor]:
        """The uniform :data:`STAT_KEYS` dict.  EF-residual norms come from
        the freshly produced errs when given, else from ``state``."""
        we = worker_err if worker_err is not None else state.worker_err
        se = server_err if server_err is not None else state.server_err
        return {"v_l1": v_l1, "grad_norm": grad_norm,
                "momentum_norm": momentum_norm,
                "worker_err_norm": torch.linalg.vector_norm(we),
                "server_err_norm": torch.linalg.vector_norm(se)}

    @property
    def _fused_warmup_ok(self) -> bool:
        """The fused Adam kernel computes the warmup update exactly iff bias
        correction is off (the kernel implements BertAdam).  The reference
        also requires its ``use_kernel`` flag and no direction-shaping
        hook; the port has neither: the device picks kernel or plain."""
        return not self.bias_correction

    # --- warmup stage ------------------------------------------------------
    def warmup_update(self, g_local: torch.Tensor, state: StateTree,
                      x: torch.Tensor, lr: float, *,
                      dp_axes: Sequence[str] = ()
                      ) -> Tuple[torch.Tensor, StateTree, dict]:
        """Uncompressed adaptive step on the dp-mean gradient; with
        :attr:`_fused_warmup_ok` the whole elementwise update is ONE fused
        op (``kernels/fused_adam``: the Hopper kernel on CUDA tensors)."""
        g = comm.allreduce_mean(g_local, dp_axes)
        count = state.count + 1
        lr = _f32(lr)
        if self._fused_warmup_ok:
            new_x, m, v = _fused_adam.adam_step(
                x, state.m, state.v, g, lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay)
        else:
            m = self.b1 * state.m + (1.0 - self.b1) * g
            v = self.b2 * state.v + (1.0 - self.b2) * torch.square(g)
            t = count.to(torch.float32)
            m_hat = m / (1.0 - self.b1 ** t)
            v_hat = v / (1.0 - self.b2 ** t)
            upd = m_hat / (torch.sqrt(v_hat) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * x
            new_x = x - lr * upd
        stats = self._stats(v_l1=v.abs().sum(),
                            grad_norm=torch.linalg.vector_norm(g),
                            momentum_norm=torch.linalg.vector_norm(m),
                            state=state)
        return new_x, state._replace(m=m, v=v, count=count), stats

    # --- compression stage (replicated layout) -------------------------------
    def update(self, g_local: torch.Tensor, state: StateTree, lr: float, *,
               x: torch.Tensor, dp_axes: Sequence[str] = ()
               ) -> Tuple[torch.Tensor, StateTree, dict]:
        """Compressed momentum step preconditioned by the frozen second
        moment: local momentum, the flat compressed exchange (EF slots
        read off the declared ``ef=`` fields), ``m_bar / (sqrt(v) + eps)``
        applied to ``x``.  ``v`` (and ``v_step``) stay as they are."""
        lr = _f32(lr)
        m_local = self.b1 * state.m + (1.0 - self.b1) * g_local
        ef_slots = tuple(s for s in self.state_slots() if s.ef is not None)
        m_bar, errs = comm.compressed_exchange(
            m_local, ef_errs(state, ef_slots), dp_axes, self.compressor)
        v = state.v                     # frozen since the switch (Alg. 1)
        upd = m_bar / (torch.sqrt(v) + self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * x
        new_x = x - lr * upd
        repl = {s.name: errs[s.ef] for s in ef_slots}
        repl.update(m=m_bar, count=state.count + 1)
        stats = self._stats(v_l1=v.abs().sum(),
                            grad_norm=torch.linalg.vector_norm(g_local),
                            momentum_norm=torch.linalg.vector_norm(m_bar),
                            worker_err=errs["worker"],
                            server_err=errs["server"])
        return new_x, state._replace(**repl), stats


_OPTIMIZERS: Dict[str, Callable[..., TwoStageOptimizer]] = {}


def register_optimizer(name: str):
    def deco(cls):
        _OPTIMIZERS[name] = cls
        return cls
    return deco


def get_optimizer(name: str, *, compressor="onebit",
                  compressor_kwargs: Optional[dict] = None,
                  **hyper) -> TwoStageOptimizer:
    """Build a registered optimizer, resolving the compressor by name (or
    accepting a ready :class:`Compressor`)."""
    from repro_torch.optim.compressors import get_compressor
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"registered: {sorted(_OPTIMIZERS)}")
    comp = (get_compressor(compressor, **(compressor_kwargs or {}))
            if isinstance(compressor, str) else compressor)
    return _OPTIMIZERS[name](compressor=comp, **hyper)


def list_optimizers():
    return sorted(_OPTIMIZERS)
