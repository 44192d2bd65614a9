"""Deterministic synthetic data: the Markov LM stream.

A copy of ``MarkovLM`` and ``lm_batches`` from ``repro/data/synthetic.py``
(numpy only), so the port trains on exactly the reference's batches:
sparse-successor Markov chains with per-token branching, a Wikipedia/Books
proxy with learnable structure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    vocab: int
    branching: int = 4
    seed: int = 0
    probs: tuple = (0.55, 0.25, 0.15, 0.05)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.succ = rng.randint(0, self.vocab, size=(self.vocab, self.branching))
        self.cum = np.cumsum(np.asarray(self.probs))

    def sample(self, batch: int, seq: int, rng: np.random.RandomState) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        state = rng.randint(0, self.vocab, size=batch)
        toks[:, 0] = state
        for t in range(seq):
            bucket = np.searchsorted(self.cum, rng.rand(batch))
            bucket = np.minimum(bucket, self.branching - 1)
            state = self.succ[state, bucket]
            toks[:, t + 1] = state
        return toks

    def entropy_floor(self) -> float:
        """Per-token CE floor of the chain (nats)."""
        p = np.asarray(self.probs)
        return float(-(p * np.log(p)).sum())


def lm_batches(
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    stream_seed: int = 1,
    extra: Optional[Dict] = None,
) -> Iterator[Dict]:
    """Infinite {"tokens","targets"} stream from a fixed Markov chain."""
    chain = MarkovLM(vocab, seed=seed)
    rng = np.random.RandomState(stream_seed)
    ex_rng = np.random.RandomState(stream_seed + 7777)
    while True:
        toks = chain.sample(batch, seq, rng)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if extra:
            for name, shape in extra.items():
                out[name] = ex_rng.randn(batch, *shape).astype(np.float32)
        yield out
