"""Plain PyTorch version of the dispatch kernels in ``csrc/moe_dispatch.cu``.

The routed rows of a dropless expert layer live in a static buffer of
R = T * k rows: row r holds the (token, choice) pair ``pair[r] = t * k + j``
or nothing (-1), and ``slot[t, j]`` is the row of pair (t, j), or -1 where
its expert is not held here.

* ``permute``: row r of the buffer is token ``pair[r] // k``'s row of x;
  an empty row is zero here (the kernel leaves it unwritten);
* ``permute_backward``: dx[t] = the sum of token t's rows of dxp, in
  choice order, in float32;
* ``combine``: y[t] = sum_j g[t, j] ye[slot[t, j]] in choice order, in
  float32;
* ``combine_backward``: dye[r] = g[pair] dy[t] (an empty row zero) and
  dg[t, j] = <dy[t], ye[slot[t, j]]> (0 where not held).

Each output is in the dtype of the rows it is made of.
"""
from __future__ import annotations

from typing import Tuple

import torch


def permute(x: torch.Tensor, pair: torch.Tensor, k: int) -> torch.Tensor:
    """(R, d) rows of x (T, d) by ``pair`` (R,)."""
    rows = x.index_select(0, torch.div(pair.clamp(min=0), k,
                                       rounding_mode="floor").long())
    return torch.where((pair >= 0)[:, None], rows, 0).to(x.dtype)


def permute_backward(dxp: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's rows of dxp (R, d) summed by ``slot`` (T, k)."""
    out = torch.zeros(slot.shape[0], dxp.shape[1], dtype=torch.float32,
                      device=dxp.device)
    for j in range(slot.shape[1]):
        s = slot[:, j]
        out = out + torch.where((s >= 0)[:, None],
                                dxp.index_select(0, s.clamp(min=0).long())
                                .float(), 0.0)
    return out.to(dxp.dtype)


def combine(ye: torch.Tensor, g: torch.Tensor, slot: torch.Tensor
            ) -> torch.Tensor:
    """(T, d): the rows of ye (R, d) that ``slot`` (T, k) names, weighted by
    the gates g (T, k) float32 and summed in choice order."""
    out = torch.zeros(slot.shape[0], ye.shape[1], dtype=torch.float32,
                      device=ye.device)
    for j in range(slot.shape[1]):
        s = slot[:, j]
        row = ye.index_select(0, s.clamp(min=0).long()).float()
        out = out + torch.where((s >= 0)[:, None], g[:, j:j + 1] * row, 0.0)
    return out.to(ye.dtype)


def combine_backward(dy: torch.Tensor, ye: torch.Tensor, g: torch.Tensor,
                     pair: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dye (R, d) in ye's dtype, dg (T, k) float32) for the cotangent dy
    (T, d) of ``combine``."""
    live = pair >= 0
    p = pair.clamp(min=0).long()
    dyr = dy.index_select(0, torch.div(p, k, rounding_mode="floor")).float()
    gr = g.reshape(-1).index_select(0, p)
    dye = torch.where(live[:, None], gr[:, None] * dyr, 0.0).to(ye.dtype)
    dot = torch.where(live, (dyr * ye.float()).sum(dim=-1), 0.0)
    dg = torch.zeros(g.numel(), dtype=torch.float32, device=g.device)
    dg = dg.index_put((p[live],), dot[live])
    return dye, dg.view(g.shape)
