"""Synthetic token-LM data: a learnable k-th-order Markov source. The
port's copy of ``repro/data/tokens.py`` (pure numpy, byte-equal batches
for every seed and start).

We sample from a sparse random transition table over the vocabulary:
each (prev token) row has ``branching`` successors with Dirichlet
weights. A model that learns the table reaches entropy << log(V);
random guessing sits at log(V).

Two properties the experiment harness leans on:

* the stream is a pure function of ``(cfg, batch, seq_len, seed)`` —
  two iterators with the same coordinates yield byte-identical batches;
* ``token_batches(..., start=k)`` fast-forwards to batch ``k`` by
  replaying the rng draws WITHOUT the transition-table work, so mid-cell
  resume rebuilds the exact stream position cheaply and stays
  byte-identical to an uninterrupted run.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab_size: int = 512
    branching: int = 8
    seed: int = 0


def _table(cfg: TokenTaskConfig) -> tuple[np.ndarray, np.ndarray]:
    """(successors (V, b) int32, probs (V, b) f32)."""
    rng = np.random.default_rng(cfg.seed)
    succ = rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branching)).astype(np.int32)
    probs = rng.dirichlet(np.full(cfg.branching, 0.5),
                          size=cfg.vocab_size).astype(np.float32)
    return succ, probs


def _sample_batch(rng: np.random.Generator, cfg: TokenTaskConfig,
                  succ: np.ndarray, probs: np.ndarray, *, batch: int,
                  seq_len: int) -> np.ndarray:
    out = np.empty((batch, seq_len + 1), np.int32)
    cur = rng.integers(0, cfg.vocab_size, size=batch)
    out[:, 0] = cur
    for t in range(1, seq_len + 1):
        u = rng.random(batch)
        cdf = np.cumsum(probs[cur], axis=1)
        choice = np.minimum((u[:, None] > cdf).sum(axis=1),
                            cfg.branching - 1)
        cur = succ[cur, choice]
        out[:, t] = cur
    return out


def _skip_batches(rng: np.random.Generator, cfg: TokenTaskConfig, *,
                  batch: int, seq_len: int, n: int) -> None:
    """Advance ``rng`` past ``n`` batches by making the same draws (same
    methods, sizes and order as :func:`_sample_batch`) without the
    transition-table lookups."""
    for _ in range(n):
        rng.integers(0, cfg.vocab_size, size=batch)
        for _ in range(seq_len):
            rng.random(batch)


def token_batches(cfg: TokenTaskConfig, *, batch: int, seq_len: int,
                  seed: int = 0, start: int = 0):
    """Infinite iterator of (tokens (B, S+1) int32) — the model trains on
    tokens[:, :-1] -> tokens[:, 1:]. ``start`` fast-forwards to batch
    index ``start`` (mid-cell resume) without generating the skipped
    batches."""
    succ, probs = _table(cfg)
    rng = np.random.default_rng(seed ^ 0x5EED)
    if start:
        _skip_batches(rng, cfg, batch=batch, seq_len=seq_len, n=start)
    while True:
        yield _sample_batch(rng, cfg, succ, probs, batch=batch,
                            seq_len=seq_len)


def token_eval_set(cfg: TokenTaskConfig, *, n: int, seq_len: int,
                   seed: int = 1) -> np.ndarray:
    """A fixed held-out (n, S+1) int32 array from the same transition
    table as the training stream but a disjoint rng stream — the
    experiment harness's eval-perplexity set."""
    succ, probs = _table(cfg)
    rng = np.random.default_rng((seed ^ 0x5EED) + 0x0E_7A1)
    return _sample_batch(rng, cfg, succ, probs, batch=n, seq_len=seq_len)
