"""The benchmark's training traffic: a Markov token stream with MLM masking.

Frozen copy of ``src/repro_torch/data/synthetic.py`` at commit 17de659
(``_markov_tokens`` and the token branch of ``make_batch``): a Zipf start
token, transitions through one fixed random permutation with 10 % uniform
noise, and for an encoder 15 % of the tokens masked with token
``vocab - 1`` (labels the unmasked tokens, the loss mask the masked
positions).  A causal model gets the next token as its label.

A batch is seeded by (seed, step, shard), so each dp rank draws its own
rows and the same seed gives the same batches to the program and to the
reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

PERM_SEED = 1234


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


def make_batch(vocab: int, causal: bool, b: int, s: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One batch as numpy arrays: int32 ``tokens`` and ``labels``, and for
    an encoder (``causal`` False) the f32 ``loss_mask`` of MLM."""
    toks = _markov_tokens(rng, b, s + 1, vocab)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    batch = {"tokens": tokens.astype(np.int32),
             "labels": labels.astype(np.int32)}
    if not causal:   # MLM: mask 15%, predict the original
        mask = rng.random(tokens.shape) < 0.15
        batch["labels"] = tokens.astype(np.int32)
        batch["tokens"] = np.where(mask, vocab - 1, tokens).astype(np.int32)
        batch["loss_mask"] = mask.astype(np.float32)
    return batch


def batch_at(vocab: int, causal: bool, b: int, s: int, seed: int,
             step: int, shard: int = 0) -> Dict[str, np.ndarray]:
    """Pool entry ``step`` of dp rank ``shard``."""
    rng = np.random.default_rng([seed, step, shard])
    return make_batch(vocab, causal, b, s, rng)


def pool(vocab: int, causal: bool, b: int, s: int, seed: int, n: int,
         shard: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n`` distinct batches, entries 0 .. n - 1."""
    return [batch_at(vocab, causal, b, s, seed, i, shard) for i in range(n)]
