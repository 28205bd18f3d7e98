"""Wrappers around the Hopper LM-head cross-entropy kernels in
``csrc/lm_head_xent.cu``.

They replace no TPU kernel: the reference left the head's f32 matmul and
its softmax to XLA.  The forward splits ``w`` (d, V_l) into three bf16
pieces, transposed to (V_l, d) (``repro_lm_head_split``), and runs the
stats kernel over them (``repro_lm_head_xent_fwd``): per row the max, the
sum of exp and the label's logit, never the logits.  Every launch cuts
its output columns into the segments ``segments`` decides, about one CTA
an SM; in the forward each CTA writes its segment's (m, s, ll), and the
segments merge here over T-length vectors.  The backward works through
the rows in chunks of ``CHUNK_ROWS``: it writes the chunk's logit
gradient as three bf16 pieces (``repro_lm_head_xent_dlogits``), then dX
of the chunk (``repro_lm_head_xent_dx``) and dW, accumulated over the
chunks in order (``repro_lm_head_xent_dw``).  A bf16 x enters as it is;
an f32 or fp16 x is split into three pieces too and every product takes
six terms.

The wrappers check device, dtype and shape, allocate every output and
scratch with ``torch.empty``, launch on ``torch.cuda.current_stream()``
without synchronising, and raise if an entry point reports a CUDA error.
``forward`` and ``backward`` each count one ``lm_head_xent_fwd`` /
``lm_head_xent_bwd`` in ``build.launch_counts()``.  CUDA tensors only:
the plain version lives in ``ref.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# rows of the logit gradient the backward holds at once (three bf16
# pieces: 4,096 x V_l x 6 bytes, 0.75 GB at BERT's V_l, 1.1 GB at
# internlm2's half vocab)
CHUNK_ROWS = 4096
# the kernels' output tile (kBM = kBN in the source): ``segments`` counts
# tiles by it
TILE = 128


class Saved(NamedTuple):
    """What the backward reuses of the forward: x as the kernels read it
    (bf16 (T, dp), or three pieces (3, T, dp)), its piece count, and w's
    transposed pieces (3, V_l, dp)."""
    xa: torch.Tensor
    na: int
    wt: torch.Tensor


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def segments(dev: torch.device, m_len: int, n_len: int) -> int:
    """Column segments of an (m_len x n_len) output: about one CTA an SM,
    each walking a run of column tiles (the producer refills the ring
    while the consumers run an epilogue), at least one, at most one a
    column tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_mt, n_nt = -(-m_len // TILE), -(-n_len // TILE)
    return max(1, min(n_nt, sms // max(n_mt, 1)))


def split(src: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Three bf16 pieces (``ref.split3``) of an f32 (rows, cols) CUDA
    tensor: (3, cols, rows8) when transposed, else (3, rows, cols8), with
    the last dim padded with zeros to a multiple of 8 (TMA's 16-byte row
    stride)."""
    if not src.is_cuda or src.dtype != torch.float32 or src.ndim != 2:
        raise ValueError(f"split: expected a 2-D float32 CUDA tensor, got "
                         f"{src.dtype} {tuple(src.shape)} on {src.device}")
    src = src.contiguous()
    rows, cols = src.shape
    shape = (3, cols, _pad8(rows)) if transpose else (3, rows, _pad8(cols))
    out = torch.empty(shape, dtype=torch.bfloat16, device=src.device)
    rc = build.load().repro_lm_head_split(
        src.data_ptr(), rows, cols, cols, out.data_ptr(), shape[2],
        shape[1] * shape[2], int(transpose), _stream(src))
    build.check(rc, "lm_head_xent split")
    return out


def _operand(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x (T, d) as the kernels read it: a bf16 x zero-padded to dp columns
    (one piece), any other dtype split into three."""
    if x.dtype == torch.bfloat16:
        d = x.shape[1]
        xa = x.contiguous() if d == _pad8(d) else F.pad(x, (0, _pad8(d) - d))
        return xa.contiguous(), 1
    if x.dtype not in (torch.float32, torch.float16):
        raise ValueError(f"lm_head_xent: x must be bf16, fp16 or f32, got "
                         f"{x.dtype}")
    return split(x.to(torch.float32), transpose=False), 3


def _check(x: torch.Tensor, w: torch.Tensor, lab: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w), ("lab", lab)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"lm_head_xent: {name} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"lm_head_xent: x (T, d) and w (d, V_l) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise ValueError(f"lm_head_xent: w must be float32, got {w.dtype}")
    if lab.dtype != torch.int32 or lab.shape != x.shape[:1]:
        raise ValueError("lm_head_xent: lab must be int32 (T,)")


def forward(x: torch.Tensor, w: torch.Tensor, lab: torch.Tensor, n_keep: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Saved]:
    """(m_l, s_l, ll_l) of x (T, d) and w (d, V_l) f32, with ``lab`` (T,)
    int32 the label's local column or -1, and what the backward reuses."""
    _check(x, w, lab)
    lib = build.load()
    t, d = x.shape
    v_l = w.shape[1]
    wt = split(w, transpose=True)
    xa, na = _operand(x)
    lab = lab.contiguous()
    dp = wt.shape[2]
    n_seg = segments(x.device, t, v_l)
    out = torch.empty(3, n_seg, t, dtype=torch.float32, device=x.device)
    rc = lib.repro_lm_head_xent_fwd(
        xa.data_ptr(), na, t, dp, t * dp, wt.data_ptr(), v_l, dp, v_l * dp,
        d, lab.data_ptr(), n_keep, n_seg, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), _stream(x))
    build.check(rc, "lm_head_xent forward")
    build.bump("lm_head_xent_fwd")
    m_seg, s_seg, ll_seg = out
    if n_seg == 1:
        m, s, ll = m_seg[0], s_seg[0], ll_seg[0]
    else:
        m = m_seg.max(dim=0).values
        s = (s_seg * torch.exp(m_seg - m)).sum(dim=0)
        ll = ll_seg.sum(dim=0)
    return m, s, ll, Saved(xa, na, wt)


def backward(saved: Saved, lab: torch.Tensor, n_keep: int, m: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, d: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dX (T, d), dW (d, V_l)), both f32, for the cotangents ``a`` of s_l
    and ``b`` of ll_l (T,)."""
    lib = build.load()
    xa, na, wt = saved
    v_l, dp = wt.shape[1], wt.shape[2]
    t = m.shape[0]
    dev = m.device
    lab, m, a, b = (v.contiguous() for v in (lab, m, a, b))
    vp = _pad8(v_l)
    rows = min(t, CHUNK_ROWS)
    ds = torch.empty(3, rows, vp, dtype=torch.bfloat16, device=dev)
    dx = torch.empty(t, d, dtype=torch.float32, device=dev)
    dw = torch.empty(d, v_l, dtype=torch.float32, device=dev)
    stream = _stream(m)
    x_piece = t * dp
    for r0 in range(0, t, rows):
        r = min(rows, t - r0)
        x0 = xa.data_ptr() + r0 * dp * xa.element_size()
        rc = lib.repro_lm_head_xent_dlogits(
            x0, na, r, dp, x_piece, wt.data_ptr(), v_l, dp, v_l * dp, d,
            lab.data_ptr() + 4 * r0, n_keep, m.data_ptr() + 4 * r0,
            a.data_ptr() + 4 * r0, b.data_ptr() + 4 * r0, ds.data_ptr(), vp,
            rows * vp, segments(dev, r, vp), stream)
        build.check(rc, "lm_head_xent dlogits")
        rc = lib.repro_lm_head_xent_dx(
            ds.data_ptr(), r, v_l, vp, rows * vp, wt.data_ptr(), d, dp,
            v_l * dp, dx.data_ptr() + 4 * r0 * d, d, 3 if na == 1 else 6,
            segments(dev, r, d), stream)
        build.check(rc, "lm_head_xent dx")
        rc = lib.repro_lm_head_xent_dw(
            x0, na, r, d, dp, x_piece, ds.data_ptr(), v_l, vp, rows * vp,
            dw.data_ptr(), v_l, int(r0 > 0), segments(dev, d, v_l), stream)
        build.check(rc, "lm_head_xent dw")
    build.bump("lm_head_xent_bwd")
    return dx, dw
