"""Deterministic, shard-aware synthetic data stream (numpy).

The same task as the reference's stream (``repro/data/synthetic.py``): a
Markov token stream with a Zipf start token, transitions through one fixed
random permutation and 10% uniform noise, and for encoders MLM masking of
15% of the tokens with token ``vocab - 1`` (labels are the unmasked
tokens, the loss mask the masked positions).  The input stubs, as the
reference's: an ``embeddings`` model (audio) takes N(0, 1) frames (B, S,
d) with Markov labels; a ``prefix`` model (VLM) takes ``S - n_prefix``
text tokens, N(0, 1) patch embeddings (B, n_prefix, d) and the shifted
labels.  Frames and patches come in the compute dtype.  The stream is
drawn from numpy, so it does not reproduce the reference's ``jax.random``
bits; parity tests feed the reference's batches instead.

``SyntheticStream(..., shard, n_shards)`` seeds each batch from (seed,
step, shard), so each dp rank sees its own reproducible slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape

PERM_SEED = 1234
# the float inputs of the stubs, carried in the compute dtype
FRAME_KEYS = ("embeddings", "patch_embeds")


def _markov_tokens(rng: np.random.Generator, b: int, s: int,
                   vocab: int) -> np.ndarray:
    perm = np.random.default_rng(PERM_SEED).permutation(vocab)
    probs = 1.0 / (np.arange(vocab) + 2.0)
    tok = rng.choice(vocab, size=b, p=probs / probs.sum())
    noise = rng.random((b, s)) < 0.1
    rand_tok = rng.integers(0, vocab, (b, s))
    out = np.empty((b, s), np.int64)
    for i in range(s):
        tok = np.where(noise[:, i], rand_tok[:, i], perm[tok])
        out[:, i] = tok
    return out


def make_batch(cfg: ArchConfig, b: int, s: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One training batch as numpy arrays (int32 tokens/labels, f32 mask,
    f32 frames or patches)."""
    if cfg.embed_kind == "embeddings":
        labels = _markov_tokens(rng, b, s, cfg.vocab)
        return {"embeddings": rng.standard_normal(
                    (b, s, cfg.d_model), dtype=np.float32),
                "labels": labels.astype(np.int32)}
    if cfg.embed_kind == "prefix":
        st = s - cfg.n_prefix
        if st <= 0:
            raise ValueError(f"seq {s} leaves no text after the "
                             f"{cfg.n_prefix}-patch prefix")
        toks = _markov_tokens(rng, b, st + 1, cfg.vocab)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "patch_embeds": rng.standard_normal(
                    (b, cfg.n_prefix, cfg.d_model), dtype=np.float32),
                "labels": toks[:, 1:].astype(np.int32)}
    toks = _markov_tokens(rng, b, s + 1, cfg.vocab)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    batch = {"tokens": tokens.astype(np.int32),
             "labels": labels.astype(np.int32)}
    if cfg.family == "encoder":   # MLM: mask 15%, predict the original
        mask = rng.random(tokens.shape) < 0.15
        batch["labels"] = tokens.astype(np.int32)
        batch["tokens"] = np.where(mask, cfg.vocab - 1,
                                   tokens).astype(np.int32)
        batch["loss_mask"] = mask.astype(np.float32)
    return batch


class SyntheticStream:
    """Deterministic per-shard stream: ``batch_at(step)`` -> tensors."""

    def __init__(self, cfg: ArchConfig, shape: InputShape, seed: int = 0,
                 shard: int = 0, n_shards: int = 1, device="cpu"):
        if shape.global_batch % n_shards:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_shards} shards")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.shard, self.n_shards = shard, n_shards
        self.local_batch = shape.global_batch // n_shards
        self.device = device

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng([self.seed, step, self.shard])
        batch = make_batch(self.cfg, self.local_batch, self.shape.seq_len,
                           rng)
        dtype = getattr(torch, self.cfg.compute_dtype)
        return {k: torch.from_numpy(v).to(
                    self.device, dtype=dtype if k in FRAME_KEYS else None)
                for k, v in batch.items()}
