"""Deterministic synthetic data streams.

A copy of ``repro/data/synthetic.py`` (numpy only, seeded as the
reference's), so the port trains on exactly the reference's batches:

  MarkovLM, lm_batches, packed_lm_batches, markov_documents — the
                  Wikipedia/Books proxy: sparse-successor Markov chains with
                  per-token branching, unpacked rows, packed rows, or
                  variable-length documents for a token cache (data/memmap.py);
  classification_data / _batches — the CIFAR10 proxy: anisotropic gaussian
                  clusters with label noise;
  CTRModel, ctr_batches — the Criteo proxy: a latent-factor click model
                  with dense side features;
  linreg_data   — the paper's sec. 7.2 linear-regression study.
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


def packed_lm_batches(
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    stream_seed: int = 1,
    min_doc: int = 0,
    max_doc: int = 0,
) -> Iterator[Dict]:
    """Infinite PACKED stream: variable-length Markov documents greedily
    packed into (batch, seq) rows (data/pipeline.pack_sequences).

    Yields {"tokens","targets","positions","segments","mask"}: positions
    restart at 0 per document (-1 on pads), segments are the per-row
    document index, mask excludes pads from the loss.  This is the batch
    layout that drives the position/segment-aware fused attention path —
    the BERT/LLM-pretraining shape the GSNR paper's 64k/128k-batch results
    assume (dense batches, no cross-document attention).
    """
    from repro_torch.data.pipeline import pack_sequences

    chain = MarkovLM(vocab, seed=seed)
    rng = np.random.RandomState(stream_seed)
    lo = min_doc or max(1, seq // 8)
    hi = max_doc or seq
    if not (1 <= lo <= hi <= seq):
        raise ValueError(f"need 1 <= min_doc <= max_doc <= seq, got {lo}, {hi}, {seq}")
    while True:
        # a row holds at most seq tokens, so total >= batch*seq guarantees
        # first-fit opens at least ``batch`` rows: ONE pack per batch
        pairs, total = [], 0
        while total < batch * seq:
            n = int(rng.randint(lo, hi + 1))
            doc = chain.sample(1, n, rng)[0]  # (n + 1,) tokens
            pairs.append((doc[:-1], doc[1:]))
            total += n
        rows = pack_sequences(pairs, seq)
        yield {k_: v[:batch] for k_, v in rows.items()}


def markov_documents(
    vocab: int,
    total_tokens: int,
    min_doc: int,
    max_doc: int,
    seed: int = 0,
    stream_seed: int = 1,
    chunk: int = 64,
) -> Iterator[np.ndarray]:
    """Finite stream of variable-length Markov documents totalling at least
    ``total_tokens`` STORED tokens — the doc source for building indexed
    memmap caches (repro_torch.data.write_token_cache).

    Each yielded doc stores n+1 tokens (n in [min_doc, max_doc]): the last
    token is the trailing next-token target, so a cache-backed pack trains
    the same (doc[:-1], doc[1:]) pairs as packed_lm_batches.  Docs are drawn
    ``chunk`` at a time from one vectorized chain.sample call (the per-token
    python loop is over chunks, not documents).
    """
    if not (1 <= min_doc <= max_doc):
        raise ValueError(f"need 1 <= min_doc <= max_doc, got {min_doc}, {max_doc}")
    chain = MarkovLM(vocab, seed=seed)
    rng = np.random.RandomState(stream_seed)
    emitted = 0
    while emitted < total_tokens:
        lens = rng.randint(min_doc, max_doc + 1, size=chunk)
        toks = chain.sample(chunk, int(lens.max()), rng)
        for i in range(chunk):
            if emitted >= total_tokens:
                return
            doc = toks[i, : int(lens[i]) + 1]
            emitted += doc.size
            yield doc


# ---------------------------------------------------------------------------
# classification (CIFAR10 proxy)
# ---------------------------------------------------------------------------


def classification_data(
    n: int, dim: int = 64, classes: int = 10, seed: int = 0, noise: float = 1.2,
    label_noise: float = 0.02, sample_seed: int = 1,
):
    """`seed` fixes the task (cluster means/scales); `sample_seed` draws the
    samples — train/test splits share `seed` and differ in `sample_seed`."""
    rng = np.random.RandomState(seed)
    means = rng.randn(classes, dim) * 2.0
    scales = 0.5 + rng.rand(classes, dim) * noise  # anisotropic clusters
    srng = np.random.RandomState(sample_seed)
    y = srng.randint(0, classes, size=n)
    x = means[y] + srng.randn(n, dim) * scales[y]
    flip = srng.rand(n) < label_noise
    y = np.where(flip, srng.randint(0, classes, size=n), y)
    return x.astype(np.float32), y.astype(np.int32)


def classification_batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    n = len(x)
    while True:
        idx = rng.randint(0, n, size=batch)
        yield {"x": x[idx], "y": y[idx]}


# ---------------------------------------------------------------------------
# CTR (Criteo / DLRM proxy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CTRModel:
    n_dense: int = 13
    n_sparse: int = 26
    table_size: int = 1 << 14
    latent: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.factors = rng.randn(self.n_sparse, self.table_size, self.latent) * 0.4
        self.dense_w = rng.randn(self.n_dense) * 0.5
        self.pair = rng.randn(self.n_sparse, self.latent) * 0.3

    def sample(self, batch: int, rng: np.random.RandomState) -> Dict:
        dense = rng.randn(batch, self.n_dense).astype(np.float32)
        # zipfian-ish sparse ids (hot heads like real CTR logs)
        u = rng.pareto(1.2, size=(batch, self.n_sparse))
        sparse = (u * 50).astype(np.int64) % self.table_size
        z = dense @ self.dense_w
        for f in range(self.n_sparse):
            z += self.factors[f, sparse[:, f]] @ self.pair[f]
        p = 1.0 / (1.0 + np.exp(-(z - z.mean())))
        label = (rng.rand(batch) < p).astype(np.float32)
        return {"dense": dense, "sparse": sparse.astype(np.int32), "label": label}


def ctr_batches(batch: int, table_size: int, n_sparse: int, seed: int = 0, stream_seed: int = 1):
    model = CTRModel(table_size=table_size, n_sparse=n_sparse, seed=seed)
    rng = np.random.RandomState(stream_seed)
    while True:
        yield model.sample(batch, rng)


# ---------------------------------------------------------------------------
# linear regression (paper §7.2)
# ---------------------------------------------------------------------------


def linreg_data(n: int, seed: int = 0, noise: float = 0.0, anisotropy: float = 0.0):
    """y = W x with W_i = i, i in [1, 10] — the paper's exact setup."""
    rng = np.random.RandomState(seed)
    w = np.arange(1.0, 11.0)
    x = rng.randn(n, 10)
    if anisotropy:
        x *= np.logspace(0, anisotropy, 10)[None, :]
    y = x @ w + noise * rng.randn(n)
    return x.astype(np.float32), y.astype(np.float32)
