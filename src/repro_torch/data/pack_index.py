"""Precomputed first-fit pack index: doc -> (row, offset), gather at train time.

A copy of ``repro/data/pack_index.py`` (numpy only), so the port's packed
rows are byte-identical to the reference's.

``pack_sequences`` (data/pipeline.py) runs greedy first-fit packing on the
host for EVERY batch.  This module runs the identical first-fit ONCE per
epoch over the shuffled document order and stores the result as flat piece
arrays, so training-time packing degenerates to a pure ``np.take`` gather
from the token memmap — zero first-fit work per batch (Megatron
gpt2_dataset.py index-mapping idiom).

Splitting contract: a stored document of length L trains L-1 next-token
pairs (doc[:-1], doc[1:]); trained spans longer than ``seq_len`` are split
into row-sized chunks BEFORE packing, each chunk packed as its own document
(positions restart at 0, fresh segment id) — exactly what ``pack_sequences``
produces when handed the pre-split chunk pairs, so the two paths agree
byte-for-byte (differential tests in tests/test_memmap.py and tests/test_torch_data.py).

Piece table (P pieces, sorted by (row, offset)):

  piece_row  (P,) int64   destination row
  piece_off  (P,) int32   destination column of the first token
  piece_seg  (P,) int32   per-row document ordinal (pack_sequences numbering)
  piece_src  (P,) int64   absolute index of the chunk's first TRAINED token
                          in the token stream (targets gather from src+1)
  piece_len  (P,) int32   trained tokens in the chunk (1..seq_len)
  row_ptr    (n_rows+1,) int64  CSR pointer: pieces of row r are
                          [row_ptr[r], row_ptr[r+1])
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.data.pipeline import _FirstFit


@dataclasses.dataclass(frozen=True)
class PackIndex:
    seq_len: int
    n_rows: int
    live_tokens: int
    piece_row: np.ndarray
    piece_off: np.ndarray
    piece_seg: np.ndarray
    piece_src: np.ndarray
    piece_len: np.ndarray
    row_ptr: np.ndarray

    @property
    def n_pieces(self) -> int:
        return int(self.piece_len.shape[0])

    @property
    def pack_efficiency(self) -> float:
        """Live tokens / total row slots — the per-epoch packing quality the
        trainer logs surface."""
        slots = self.n_rows * self.seq_len
        return float(self.live_tokens) / float(max(slots, 1))


def build_pack_index(
    doc_lens: np.ndarray,
    doc_offsets: np.ndarray,
    order: np.ndarray,
    seq_len: int,
) -> PackIndex:
    """First-fit pack the epoch's documents (in ``order``) into rows.

    doc_lens:    (n_docs,) STORED lengths (a stored doc trains len-1 pairs;
                 docs with < 2 stored tokens are skipped, mirroring
                 pack_sequences skipping empty pairs)
    doc_offsets: (n_docs,) absolute offset of each doc in the token stream
    order:       the epoch's shuffled doc-id permutation

    Identical placement to pack_sequences on the pre-split chunk pairs: same
    _FirstFit tree, same insertion order, same per-row segment numbering.
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len={seq_len} must be positive")
    doc_lens = np.asarray(doc_lens, np.int64)
    doc_offsets = np.asarray(doc_offsets, np.int64)
    ff = _FirstFit()
    fill: list = []
    nseg: list = []
    rows_: list = []
    offs_: list = []
    segs_: list = []
    srcs_: list = []
    lens_: list = []
    for d in order:
        trained = int(doc_lens[d]) - 1
        if trained <= 0:
            continue
        start = int(doc_offsets[d])
        for chunk in range(0, trained, seq_len):
            n = min(seq_len, trained - chunk)
            ri = ff.find(n)
            if ri is None:
                fill.append(0)
                nseg.append(0)
                ri = ff.add_row(seq_len)
            ff.take(ri, n)
            rows_.append(ri)
            offs_.append(fill[ri])
            segs_.append(nseg[ri])
            srcs_.append(start + chunk)
            lens_.append(n)
            fill[ri] += n
            nseg[ri] += 1
    if not rows_:
        raise ValueError(
            "build_pack_index: cache holds no trainable documents "
            "(every stored doc has < 2 tokens)"
        )
    piece_row = np.asarray(rows_, np.int64)
    piece_off = np.asarray(offs_, np.int32)
    piece_seg = np.asarray(segs_, np.int32)
    piece_src = np.asarray(srcs_, np.int64)
    piece_len = np.asarray(lens_, np.int32)
    sort = np.lexsort((piece_off, piece_row))
    piece_row, piece_off = piece_row[sort], piece_off[sort]
    piece_seg, piece_src, piece_len = piece_seg[sort], piece_src[sort], piece_len[sort]
    n_rows = len(fill)
    row_ptr = np.searchsorted(piece_row, np.arange(n_rows + 1, dtype=np.int64))
    return PackIndex(
        seq_len=int(seq_len),
        n_rows=n_rows,
        live_tokens=int(piece_len.sum()),
        piece_row=piece_row,
        piece_off=piece_off,
        piece_seg=piece_seg,
        piece_src=piece_src,
        piece_len=piece_len,
        row_ptr=row_ptr.astype(np.int64),
    )


def gather_rows(
    pack: PackIndex,
    tokens: np.ndarray,
    lo: int,
    hi: int,
    pad_id: int = 0,
    pad_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Materialize packed rows [lo, hi) as a batch dict — pure np.take.

    tokens: the (possibly memmapped) token stream the index was built over.
    pad_to: when given, append all-pad rows up to ``pad_to`` rows (fixed jit
    shapes for a ragged final eval batch; pads carry position -1 / mask 0 so
    they weigh nothing in eval_loss).

    Emits the exact ``pack_sequences`` contract: {"tokens","targets",
    "positions","segments","mask"} with positions restarting at 0 per piece
    (-1 on pads), segments the per-row document ordinal (-1 on pads), mask
    1.0 on real tokens.
    """
    if not (0 <= lo <= hi <= pack.n_rows):
        raise ValueError(f"gather_rows: rows [{lo}, {hi}) outside [0, {pack.n_rows})")
    nb = hi - lo
    b = max(nb, pad_to or 0)
    s = pack.seq_len
    out_tokens = np.full(b * s, pad_id, np.int32)
    out_targets = np.zeros(b * s, np.int32)
    out_positions = np.full(b * s, -1, np.int32)
    out_segments = np.full(b * s, -1, np.int32)
    out_mask = np.zeros(b * s, np.float32)
    p0, p1 = int(pack.row_ptr[lo]), int(pack.row_ptr[hi])
    if p1 > p0:
        lens = pack.piece_len[p0:p1].astype(np.int64)
        total = int(lens.sum())
        reps = np.repeat(np.arange(p1 - p0, dtype=np.int64), lens)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        intra = np.arange(total, dtype=np.int64) - starts[reps]
        dst = (pack.piece_row[p0:p1][reps] - lo) * s + pack.piece_off[p0:p1][reps] + intra
        src = pack.piece_src[p0:p1][reps] + intra
        out_tokens[dst] = np.take(tokens, src).astype(np.int32)
        out_targets[dst] = np.take(tokens, src + 1).astype(np.int32)
        out_positions[dst] = intra.astype(np.int32)
        out_segments[dst] = pack.piece_seg[p0:p1][reps]
        out_mask[dst] = 1.0
    return {
        "tokens": out_tokens.reshape(b, s),
        "targets": out_targets.reshape(b, s),
        "positions": out_positions.reshape(b, s),
        "segments": out_segments.reshape(b, s),
        "mask": out_mask.reshape(b, s),
    }
