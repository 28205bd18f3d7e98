"""The training step: forward/backward into a flat f32 gradient, then the
optimizer's warmup or compressed update, then the dp-mean metrics.

The reference runs this inside one ``shard_map``; here each process is
one dp rank and the only dp communication is the optimizer's own exchange
(``repro_torch.core.comm``): an uncompressed all-reduce mean in the
warmup stage, the error-compensated compressed all_to_all/all_gather
schedule in the compression stage.  Autograd averages nothing over dp.

State lives in a :class:`TrainState`: the flat parameter vector ``x``
(length ``d_pad``, the ravel order of the reference, zero tail), the flat
gradient ``g`` the model's parameters accumulate into, the model whose
parameters are views of ``x``, and the optimizer's state tree.  The step
writes the optimizer's new parameters into ``x[:d]`` in place; as in the
reference, the padding tail of ``x`` stays zero (the reference rebuilds it
from the unpadded parameters every step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import flat_from_params
from repro_torch.core import comm
from repro_torch.core.compression import padded_length
from repro_torch.models.transformer import (Transformer, flat_size,
                                            leaf_shapes, loss_fn)
from repro_torch.optim.base import TwoStageOptimizer
from repro_torch.state.slots import StateTree

STAGES = ("warmup", "compressed")


def flat_dim(cfg: ArchConfig, n_dp: int, block: int) -> int:
    """Padded flat parameter length: a multiple of n_dp * block."""
    return padded_length(flat_size(cfg), max(n_dp, 1), block)


def n_segments(cfg: ArchConfig, d_pad: int) -> int:
    """ravel_pytree leaves, plus the padding tail as its own segment."""
    n = len(leaf_shapes(cfg))
    return n + (1 if d_pad > flat_size(cfg) else 0)


@dataclasses.dataclass
class TrainState:
    model: Transformer
    x: torch.Tensor          # (d_pad,) flat params; model params are views
    g: torch.Tensor          # (d_pad,) flat grads; model grads are views
    opt: StateTree
    d: int                   # unpadded parameter count


def init_train_state(cfg: ArchConfig, params: Dict[str, torch.Tensor],
                     optimizer: TwoStageOptimizer, block: int,
                     n_dp: int = 1, device="cpu") -> TrainState:
    """Flat buffers, the model over them, and zeros optimizer state."""
    d = flat_size(cfg)
    d_pad = flat_dim(cfg, n_dp, block)
    x = flat_from_params(params, d_pad).to(device)
    g = torch.zeros_like(x)
    model = Transformer(cfg, x)
    model.bind_grads(g)
    opt = optimizer.init_state(d_pad, n_dp, n_segments(cfg, d_pad), device)
    return TrainState(model=model, x=x, g=g, opt=opt, d=d)


def _dp_mean(vals: Dict[str, torch.Tensor], dp_axes: Sequence[str]
             ) -> Dict[str, torch.Tensor]:
    """Mean over dp of a dict of scalars, in one all-reduce."""
    if not dp_axes:
        return vals
    keys = list(vals)
    buf = torch.stack([vals[k].to(torch.float32) for k in keys])
    return dict(zip(keys, comm.allreduce_mean(buf, dp_axes).unbind()))


def train_step(ts: TrainState, optimizer: TwoStageOptimizer,
               batch: Dict[str, torch.Tensor], lr: float, stage: str,
               dp_axes: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """One step of ``stage`` ("warmup" | "compressed"); updates ``ts`` and
    returns the metrics (0-dim tensors): loss/aux/acc/total dp-meaned,
    ``v_l1`` (replicated), the other :data:`STAT_KEYS` dp-meaned."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    ts.g.zero_()
    total, metrics = loss_fn(ts.model, batch)
    total.backward()
    if stage == "warmup":
        new_x, ts.opt, stats = optimizer.warmup_update(
            ts.g, ts.opt, ts.x, lr, dp_axes=dp_axes)
    else:
        new_x, ts.opt, stats = optimizer.update(
            ts.g, ts.opt, lr, x=ts.x, dp_axes=dp_axes)
    with torch.no_grad():
        ts.x[:ts.d].copy_(new_x[:ts.d])
    out = {k: v.detach() for k, v in metrics.items()}
    out["total"] = total.detach()
    out.update({k: v for k, v in stats.items() if k != "v_l1"})
    out = _dp_mean(out, dp_axes)
    out["v_l1"] = stats["v_l1"]
    return out
