"""Plain PyTorch reference of 1-bit Adam (Algorithm 1 of the paper) on one
rank's flat parameter vector.

Warmup stage: BertAdam on the dp-mean gradient (no bias correction, no
weight decay): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``x -= lr * m / (sqrt(v) + eps)``.

Compression stage (``v`` frozen): the local momentum
``b1 m + (1 - b1) g_local`` plus the worker's error is compressed to one
sign a coordinate and one scale a block (``mean |.|`` over ``block``
consecutive coordinates; a coordinate >= 0 takes ``+scale``), the
residual kept as the new worker error; every dp rank's compressed value
is averaged chunk by chunk (rank ``r`` averages chunk ``r`` of each, in
rank order), the average plus the server error compressed again, its
residual kept; the compressed averages of every chunk make the new
momentum, and ``x -= lr * m / (sqrt(v) + eps)``.

Each rank holds its own state; the dp ranks meet through
``torch.distributed`` (``dp_group``; none with one dp rank).  ``dtype``
is the state's precision (float32 as configured; the control runs it a
step lower): every state tensor is stored in it, the arithmetic of a step
is float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _f32(a: float) -> float:
    """The float32 value of a Python scalar."""
    return float(torch.tensor(a, dtype=torch.float32))


class OneBitAdam:
    def __init__(self, x0: torch.Tensor, n_dp: int = 1,
                 dp_group: Optional[object] = None, block: int = 4096,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 dtype=torch.float32):
        d = x0.shape[0]
        if d % (n_dp * block):
            raise ValueError(f"{d} elements do not split into {n_dp} "
                             f"chunks of {block}-element blocks")
        self.n_dp, self.group, self.block = n_dp, dp_group, block
        self.b1, self.b2, self.eps = b1, b2, eps
        self.dtype = dtype
        self.x = x0.to(dtype).clone()
        self.m = torch.zeros_like(self.x)
        self.v = torch.zeros_like(self.x)
        self.worker_err = torch.zeros_like(self.x)
        self.server_err = torch.zeros(d // n_dp, dtype=dtype,
                                      device=x0.device)

    def load(self, state: dict) -> None:
        """Take the tensors of ``state`` (any of ``x``, ``m``, ``v``,
        ``worker_err``, ``server_err``; any device), stored in this
        state's dtype."""
        dev = self.x.device
        for k, t in state.items():
            setattr(self, k, t.to(dev).to(self.dtype))

    def _store(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def _dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.n_dp > 1:
            t = t.clone()
            dist.all_reduce(t, group=self.group)
        return t

    def _compress(self, buf: torch.Tensor) -> torch.Tensor:
        """The value one sign a coordinate and one scale a block stand
        for."""
        blocks = buf.view(-1, self.block)
        scale = blocks.abs().mean(dim=1, keepdim=True)
        return torch.where(blocks >= 0, scale, -scale).view(-1)

    def warmup_step(self, g_local: torch.Tensor, lr: float) -> torch.Tensor:
        """One BertAdam step on the dp mean; returns that mean."""
        g = self._dp_sum(g_local.float()) / self.n_dp if self.n_dp > 1 \
            else g_local.float()
        b1, b2 = self.b1, self.b2
        m = b1 * self.m.float() + (1.0 - b1) * g
        v = b2 * self.v.float() + (1.0 - b2) * g * g
        x = self.x.float() - _f32(lr) * (m / (torch.sqrt(v) + self.eps))
        self.m, self.v, self.x = self._store(m), self._store(v), \
            self._store(x)
        return g

    def compressed_step(self, g_local: torch.Tensor, lr: float) -> None:
        """One compression-stage step."""
        b1 = self.b1
        buf = b1 * self.m.float() + (1.0 - b1) * g_local.float() \
            + self.worker_err.float()
        sent = self._compress(buf)
        self.worker_err = self._store(buf - sent)
        n, chunk = self.n_dp, buf.shape[0] // self.n_dp
        if n > 1:
            every = torch.empty(n * buf.shape[0], dtype=sent.dtype,
                                device=sent.device)
            dist.all_gather_into_tensor(every, sent, group=self.group)
            every = every.view(n, -1)
            r = dist.get_rank(self.group)
            got = every[:, r * chunk:(r + 1) * chunk]
            acc = got[0]
            for j in range(1, n):
                acc = acc + got[j]
            avg = acc / n
            del every, got
        else:
            avg = sent
        buf2 = avg + self.server_err.float()
        back = self._compress(buf2)
        self.server_err = self._store(buf2 - back)
        if n > 1:
            m_bar = torch.empty(buf.shape[0], dtype=back.dtype,
                                device=back.device)
            dist.all_gather_into_tensor(m_bar, back, group=self.group)
        else:
            m_bar = back
        m = self._store(m_bar)
        x = self.x.float() - _f32(lr) * (m.float() / (
            torch.sqrt(self.v.float()) + self.eps))
        self.m, self.x = m, self._store(x)
