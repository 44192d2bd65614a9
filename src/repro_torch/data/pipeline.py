"""Host data pipeline: sequence packing, batch placement and prefetch.

Port of ``repro/data/pipeline.py``.  Packing is numpy, a copy of the
reference's, so packed batches are byte-identical to its.  Packing
contract (shared with models/attention.py and the attention kernels):
positions restart at 0 for every document, pads carry position -1, and
segment ids are the per-row document index (pads get -1).

Placement: the global batch splits into W contiguous row blocks, one per
rank, as ``P(data)`` shards it in the reference (``shard_batch``).  Rank r's
rows ``[r B/W, (r+1) B/W)`` are microbatch r of
``core/accumulate.py::split_batch(batch, W)``, which is why a W-rank
data-parallel step sees the same groups as a k=W microbatch step.

Prefetch: ``prefetch`` runs an iterator in a background thread (the
reference's ``_Prefetcher``).  ``device_prefetch`` also places each batch on
the device inside that thread: on the card, each leaf is copied into pinned
host memory and from there to the card on a side stream, an event is
recorded after the batch's copies, and the consumer's stream waits on that
event before it is handed the batch (each tensor ``record_stream``-ed to the
consumer's stream, so the caching allocator does not reuse its memory while
the consumer's work on it is queued).  On the CPU the thread only makes
tensors.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class _FirstFit:
    """Leftmost row with free capacity >= n, in O(log rows) per query.

    A 1-indexed max-tree over per-row free capacities (empty leaves hold 0,
    so they can never win for n >= 1); the descent always prefers the left
    child, which is exactly first-fit order."""

    def __init__(self):
        self.free: List[int] = []
        self.cap = 1
        self.tree = [0, 0]

    def _set(self, i: int, val: int) -> None:
        j = self.cap + i
        self.tree[j] = val
        j //= 2
        while j:
            self.tree[j] = max(self.tree[2 * j], self.tree[2 * j + 1])
            j //= 2

    def add_row(self, free: int) -> int:
        self.free.append(free)
        if len(self.free) > self.cap:
            self.cap *= 2
            self.tree = [0] * (2 * self.cap)
            for i, f in enumerate(self.free):
                self.tree[self.cap + i] = f
            for j in range(self.cap - 1, 0, -1):
                self.tree[j] = max(self.tree[2 * j], self.tree[2 * j + 1])
        else:
            self._set(len(self.free) - 1, free)
        return len(self.free) - 1

    def take(self, i: int, n: int) -> None:
        self.free[i] -= n
        self._set(i, self.free[i])

    def find(self, n: int) -> Optional[int]:
        if self.tree[1] < n:
            return None
        j = 1
        while j < self.cap:
            j *= 2
            if self.tree[j] < n:
                j += 1
        return j - self.cap


def pack_sequences(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    seq_len: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing of (tokens, targets) documents into rows.

    pairs: per-document 1-D int arrays of equal length (already next-token
    aligned within the document).  Documents longer than seq_len raise;
    each document lands in the FIRST open row with room, so the row count
    is data-dependent and the layout order-deterministic.

    Returns {"tokens", "targets", "positions", "segments", "mask"} stacked
    (rows, seq_len): positions restart at 0 per document and are -1 on pads,
    segments number the documents within each row (-1 on pads), mask is
    1.0 on real tokens."""
    rows: List[Dict[str, np.ndarray]] = []
    fill: List[int] = []
    nseg: List[int] = []
    ff = _FirstFit()

    def new_row():
        rows.append({
            "tokens": np.full(seq_len, pad_id, np.int32),
            "targets": np.zeros(seq_len, np.int32),
            "positions": np.full(seq_len, -1, np.int32),
            "segments": np.full(seq_len, -1, np.int32),
            "mask": np.zeros(seq_len, np.float32),
        })
        fill.append(0)
        nseg.append(0)
        return ff.add_row(seq_len)

    for toks, tgts in pairs:
        toks = np.asarray(toks, np.int32).reshape(-1)
        tgts = np.asarray(tgts, np.int32).reshape(-1)
        if toks.shape != tgts.shape:
            raise ValueError(f"tokens/targets length mismatch: {toks.shape} vs {tgts.shape}")
        n = len(toks)
        if n > seq_len:
            raise ValueError(f"document length {n} exceeds seq_len {seq_len}")
        if n == 0:
            continue
        ri = ff.find(n)
        if ri is None:
            ri = new_row()
        ff.take(ri, n)
        r, o = rows[ri], fill[ri]
        r["tokens"][o: o + n] = toks
        r["targets"][o: o + n] = tgts
        r["positions"][o: o + n] = np.arange(n, dtype=np.int32)
        r["segments"][o: o + n] = nseg[ri]
        r["mask"][o: o + n] = 1.0
        fill[ri] += n
        nseg[ri] += 1

    if not rows:
        new_row()
    return {k_: np.stack([r[k_] for r in rows]) for k_ in rows[0]}


def host_slice(batch: Dict, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Dict:
    """This process's contiguous block of rows of every leaf; the index and
    count default to the default process group's rank and size (one
    process, the whole batch, when none is initialized)."""
    if process_index is None or process_count is None:
        grouped = torch.distributed.is_available() and torch.distributed.is_initialized()
        pi = torch.distributed.get_rank() if grouped else 0
        pc = torch.distributed.get_world_size() if grouped else 1
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    if process_count == 1:
        return batch
    out = {}
    for name, x in batch.items():
        per = x.shape[0] // process_count
        out[name] = x[process_index * per: (process_index + 1) * per]
    return out


def shard_batch(batch: Dict, mesh) -> Dict:
    """This rank's rows of every (B, ...) leaf of ``batch``; raises when B
    does not divide over the mesh's ranks."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"shard_batch: leaf {name!r} has batch {b}, not divisible over "
                             f"{mesh.size} ranks (remainder {b % mesh.size})")
        per = b // mesh.size
        out[name] = x[mesh.rank * per: (mesh.rank + 1) * per]
    return out


class _Prefetcher:
    """Background-thread prefetch with prompt error propagation.

    - A producer exception is re-raised on the CONSUMER side as soon as the
      consumer asks for the next item, ahead of any still-queued items,
      with the worker thread's traceback attached.
    - ``close()`` stops the producer: the worker wakes from its
      backpressure wait, exits, and is joined."""

    def __init__(self, it: Iterator, size: int):
        if size < 1:
            raise ValueError(f"prefetch size={size} must be >= 1")
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._size = size
        self._done = False
        self._exc: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._work, args=(it,), daemon=True)
        self._thread.start()

    def _work(self, it: Iterator) -> None:
        try:
            for item in it:
                with self._cv:
                    while len(self._q) >= self._size and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        return
                    self._q.append(item)
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            with self._cv:
                self._exc = e
                self._cv.notify_all()
            return
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def __iter__(self) -> "_Prefetcher":
        return self

    def __next__(self):
        with self._cv:
            while True:
                if self._exc is not None:
                    self._stop = True
                    self._cv.notify_all()
                    raise self._exc
                if self._q:
                    item = self._q.popleft()
                    self._cv.notify_all()
                    return item
                if self._done:
                    raise StopIteration
                self._cv.wait()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover — interpreter shutdown
            pass


def prefetch(it: Iterator, size: int = 2) -> _Prefetcher:
    """Background-thread prefetch of host batches (errors propagate promptly;
    ``.close()`` stops the worker)."""
    return _Prefetcher(it, size)


class _Placer:
    """Host batch -> tensors on ``device``.  ``put`` runs in the producer
    thread; on the card it copies through pinned memory on a side stream and
    returns the event recorded after the copies.  ``take`` runs in the
    consumer: its stream waits on that event and takes over the tensors."""

    def __init__(self, device):
        from repro_torch.serve.engine import resolve_device

        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def put(self, batch: Dict):
        if self.stream is None:
            return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def take(self, placed) -> Dict:
        batch, event = placed
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch


class _PlacedPrefetch:
    """Batches of ``it`` placed by a producer thread, handed over to the
    consumer's stream as they are taken."""

    def __init__(self, it: Iterator, size: int, device):
        self._placer = _Placer(device)
        self._it = prefetch((self._placer.put(b) for b in it), size)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        return self._placer.take(next(self._it))

    def close(self) -> None:
        self._it.close()


def device_prefetch(it: Iterator, size: int = 2, device=None) -> _PlacedPrefetch:
    """Double-buffered host -> device pipeline: each batch is placed on
    ``device`` (None: the card) INSIDE the producer thread, so the copy
    overlaps the running step instead of serializing with it (see the
    module note for the streams)."""
    return _PlacedPrefetch(it, size, device)


def device_stream(it: Iterator, device=None, prefetch_size: int = 2):
    """Host batches prefetched in a background thread, this process's rows
    (``host_slice``) placed on ``device`` (None: the card) by the consumer."""
    from repro_torch.serve.engine import resolve_device

    device = resolve_device(device)
    for batch in prefetch(it, prefetch_size):
        batch = host_slice(batch)
        yield {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
