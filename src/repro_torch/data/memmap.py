"""Indexed memmap token datasets: build-once on-disk caches, deterministic
epoch shuffles, gather-packed batches, and exact mid-epoch resume.

Port of ``repro/data/memmap.py``: the cache format, the shuffles and the
packed batches are the reference's, byte for byte, so either package reads
the other's cache and serves the same rows from the same cursor.

Cache layout (``cache_dir/``):

  meta.json     {"magic", "version", "dtype", "n_docs", "n_tokens", "vocab"?}
  tokens.bin    raw token stream (np.memmap, dtype from meta)
  doc_lens.npy  (n_docs,) int64 STORED document lengths (>= 1)

Documents are stored with their trailing next-token target: a stored doc of
length L trains L-1 (tokens, targets) pairs — ``(doc[:-1], doc[1:])`` — so
targets gather from the same stream at ``src + 1`` and never cross documents.

Per-epoch document order is a deterministic permutation keyed by
``(seed, epoch)`` (np.random.default_rng), so any (epoch, row) cursor
reproduces its stream exactly: that pair plus the seed IS the resume state
(:class:`DataState`), and it round-trips through ``train/checkpoint.py``.

Training-time packing is a pure gather through the per-epoch
:class:`~repro_torch.data.pack_index.PackIndex`.  Batches are numpy on the
host; ``iter_batches(device=...)`` places them as tensors, through
data/pipeline.py's device prefetch when ``prefetch_size`` > 0.  Validate a
cache with ``python -m repro_torch.data.check CACHE_DIR`` (data/check.py).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.data.pack_index import PackIndex, build_pack_index, gather_rows

MAGIC = "repro-token-cache"
VERSION = 1

_META = "meta.json"
_TOKENS = "tokens.bin"
_DOC_LENS = "doc_lens.npy"

_DTYPES = {"int32": np.int32, "uint16": np.uint16, "int64": np.int64, "uint32": np.uint32}


def write_token_cache(
    docs: Iterable[np.ndarray],
    cache_dir: str,
    dtype=np.int32,
    vocab: Optional[int] = None,
) -> Dict:
    """Stream ``docs`` (1-D int token arrays, stored length >= 1) into a
    cache directory.  Returns the written meta dict."""
    dtype = np.dtype(dtype)
    if dtype.name not in _DTYPES:
        raise ValueError(f"dtype {dtype.name!r} not in {sorted(_DTYPES)}")
    os.makedirs(cache_dir, exist_ok=True)
    lens = []
    n_tokens = 0
    with open(os.path.join(cache_dir, _TOKENS), "wb") as f:
        for doc in docs:
            a = np.asarray(doc).reshape(-1).astype(dtype)
            if a.size == 0:
                raise ValueError("write_token_cache: empty document")
            if vocab is not None and (a.max() >= vocab or a.min() < 0):
                raise ValueError(
                    f"write_token_cache: token outside [0, {vocab}) in doc {len(lens)}"
                )
            f.write(a.tobytes())
            lens.append(a.size)
            n_tokens += a.size
    np.save(os.path.join(cache_dir, _DOC_LENS), np.asarray(lens, np.int64))
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "dtype": dtype.name,
        "n_docs": len(lens),
        "n_tokens": n_tokens,
    }
    if vocab is not None:
        meta["vocab"] = int(vocab)
    with open(os.path.join(cache_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_meta(cache_dir: str) -> Dict:
    path = os.path.join(cache_dir, _META)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: not a token cache (meta.json missing)")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: bad magic {meta.get('magic')!r} (want {MAGIC!r})")
    if meta.get("version") != VERSION:
        raise ValueError(f"{path}: version {meta.get('version')!r} != {VERSION}")
    if meta.get("dtype") not in _DTYPES:
        raise ValueError(f"{path}: unknown dtype {meta.get('dtype')!r}")
    return meta


class TokenCache:
    """Read-only view of a written cache: the token memmap plus doc index."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self.meta = load_meta(cache_dir)
        self.dtype = np.dtype(self.meta["dtype"])
        self.n_docs = int(self.meta["n_docs"])
        self.n_tokens = int(self.meta["n_tokens"])
        bin_path = os.path.join(cache_dir, _TOKENS)
        size = os.path.getsize(bin_path)
        want = self.n_tokens * self.dtype.itemsize
        if size != want:
            raise ValueError(
                f"{bin_path}: truncated/corrupt — {size} bytes on disk, meta "
                f"promises {want} ({self.n_tokens} x {self.dtype.name})"
            )
        self.tokens = np.memmap(bin_path, dtype=self.dtype, mode="r", shape=(self.n_tokens,))
        self.doc_lens = np.load(os.path.join(cache_dir, _DOC_LENS))
        if self.doc_lens.shape != (self.n_docs,):
            raise ValueError(
                f"doc_lens shape {self.doc_lens.shape} != ({self.n_docs},)"
            )
        if int(self.doc_lens.sum()) != self.n_tokens:
            raise ValueError(
                f"doc_lens sum {int(self.doc_lens.sum())} != n_tokens {self.n_tokens}"
            )
        self.doc_offsets = np.concatenate(
            [[0], np.cumsum(self.doc_lens, dtype=np.int64)[:-1]]
        )

    def doc(self, i: int) -> np.ndarray:
        o = int(self.doc_offsets[i])
        return np.asarray(self.tokens[o : o + int(self.doc_lens[i])])

    def epoch_order(self, seed: int, epoch: int) -> np.ndarray:
        """Deterministic per-epoch doc permutation keyed by (seed, epoch)."""
        return np.random.default_rng([int(seed), int(epoch)]).permutation(self.n_docs)


class DataState(NamedTuple):
    """Serializable mid-epoch resume cursor.  (seed, epoch) keys the shuffle
    RNG; row is the pack-index row cursor inside that epoch.  Leaves are
    int64 scalars so the state round-trips through train/checkpoint.py."""

    epoch: np.ndarray
    row: np.ndarray
    seed: np.ndarray

    @staticmethod
    def make(epoch: int = 0, row: int = 0, seed: int = 0) -> "DataState":
        return DataState(np.int64(epoch), np.int64(row), np.int64(seed))


class IndexedPackedDataset:
    """Iterator over gather-packed (rows, seq_len) batches with exact resume.

    - Per-epoch pack index built once (first-fit), batches are pure gathers.
    - ``next_batch(rows)`` serves ANY row count, spanning epoch boundaries —
      the autoscale loop drives the LOADER batch by asking for k x batch_rows
      rows when k changes (no fixed host batch to re-slice).
    - ``state`` is the :class:`DataState` after the last served batch;
      constructing with ``state=`` resumes element-wise identically.
    - ``epoch_stats[epoch]`` records pack_efficiency per built epoch.
    """

    def __init__(
        self,
        cache: Union[TokenCache, str],
        seq_len: int,
        batch_rows: int,
        *,
        seed: int = 0,
        state: Optional[DataState] = None,
        pad_id: int = 0,
    ):
        self.cache = cache if isinstance(cache, TokenCache) else TokenCache(cache)
        self.seq_len = int(seq_len)
        self.batch_rows = int(batch_rows)
        self.pad_id = pad_id
        if self.seq_len <= 0 or self.batch_rows <= 0:
            raise ValueError(
                f"seq_len={seq_len} and batch_rows={batch_rows} must be positive"
            )
        if state is not None:
            self._epoch = int(state.epoch)
            self._row = int(state.row)
            self.seed = int(state.seed)
        else:
            self._epoch, self._row, self.seed = 0, 0, int(seed)
        self._packs: Dict[int, PackIndex] = {}
        self.epoch_stats: Dict[int, float] = {}
        self._last_epoch_used: Optional[int] = None

    @property
    def state(self) -> DataState:
        return DataState.make(self._epoch, self._row, self.seed)

    @property
    def last_pack_efficiency(self) -> Optional[float]:
        if self._last_epoch_used is None:
            return None
        return self.epoch_stats.get(self._last_epoch_used)

    def pack_for(self, epoch: int) -> PackIndex:
        """The epoch's pack index (built once, cached for two epochs)."""
        if epoch not in self._packs:
            order = self.cache.epoch_order(self.seed, epoch)
            pk = build_pack_index(
                self.cache.doc_lens, self.cache.doc_offsets, order, self.seq_len
            )
            self._packs[epoch] = pk
            self.epoch_stats[epoch] = pk.pack_efficiency
            while len(self._packs) > 2:
                drop = min(k for k in self._packs if k != epoch)
                del self._packs[drop]
        return self._packs[epoch]

    def next_batch(self, rows: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The next ``rows`` packed rows (default batch_rows), advancing the
        cursor; spans epoch boundaries when the epoch's rows run out."""
        need = int(rows or self.batch_rows)
        if need <= 0:
            raise ValueError(f"next_batch: rows={rows} must be positive")
        parts = []
        while need:
            pack = self.pack_for(self._epoch)
            self._last_epoch_used = self._epoch
            take = min(need, pack.n_rows - self._row)
            if take:
                parts.append(
                    gather_rows(
                        pack, self.cache.tokens, self._row, self._row + take,
                        pad_id=self.pad_id,
                    )
                )
                self._row += take
                need -= take
            if self._row >= pack.n_rows:
                self._epoch += 1
                self._row = 0
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def epoch_batches(
        self, epoch: int = 0, rows: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """One finite, deterministic pass over ``epoch`` (eval streams) —
        does NOT touch the training cursor.  The ragged final batch is padded
        to full rows (all-pad rows weigh nothing in eval_loss)."""
        rows = int(rows or self.batch_rows)
        pack = self.pack_for(epoch)
        for lo in range(0, pack.n_rows, rows):
            hi = min(lo + rows, pack.n_rows)
            yield gather_rows(
                pack, self.cache.tokens, lo, hi, pad_id=self.pad_id, pad_to=rows
            )

    def iter_batches(
        self,
        rows: Optional[int] = None,
        device=False,
        prefetch_size: int = 0,
    ):
        """Infinite fixed-size batch iterator.  ``device`` False yields host
        numpy batches; True (the card) or a device places them as tensors.
        ``prefetch_size > 0`` gathers (and places) batches in a background
        thread, double-buffered by default ahead of the running step; the
        returned iterator's ``.state`` then reports the DataState after the
        last batch the CONSUMER received (the producer runs ahead, so
        ``dataset.state`` alone would over-advance a checkpoint)."""
        if prefetch_size:
            return _TrackedPrefetch(self, rows, device, prefetch_size)

        def _sync():
            dev = _placement(device)
            while True:
                batch = self.next_batch(rows)
                yield batch if dev is None else {k: torch.from_numpy(v).to(dev)
                                                 for k, v in batch.items()}

        return _sync()


def _placement(device) -> Optional[torch.device]:
    """None keeps batches on the host (``device`` False or None); else the
    device they are placed on (True: the card)."""
    if device is False or device is None:
        return None
    from repro_torch.serve.engine import resolve_device

    return resolve_device(None if device is True else device)


class _TrackedPrefetch:
    """Background-prefetched batches that still expose an exact resume state."""

    def __init__(self, ds: IndexedPackedDataset, rows, device, size: int):
        from repro_torch.data.pipeline import _Placer, prefetch

        dev = _placement(device)
        placer = None if dev is None else _Placer(dev)

        def produce():
            while True:
                batch = ds.next_batch(rows)
                st = ds.state
                yield (placer.put(batch) if placer else batch, st)

        self._placer = placer
        self._it = prefetch(produce(), size=size)
        self.state: Optional[DataState] = None

    def __iter__(self):
        return self

    def __next__(self):
        batch, st = next(self._it)
        self.state = st
        return self._placer.take(batch) if self._placer else batch

    def close(self):
        self._it.close()
