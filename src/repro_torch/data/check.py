"""Token-cache validator: ``python -m repro_torch.data.check CACHE_DIR``.

Port of ``repro/data/check.py``: the same findings and exit codes.

Levanter ``check_cache.py`` idiom: verify the on-disk cache BEFORE a long
run touches it — header magic/version/dtype, doc-index/stream length
agreement, byte-exact file sizes (truncation), token vocab bounds, and
(with ``--seq-len``) the per-epoch pack index's structural invariants:
piece bounds, contiguous first-fit row fills, source spans inside the
stream, and exact live-token coverage.

Exits non-zero with ``# DATA: ...`` lines on any finding.  ``chip_smoke.py``
runs it in-process on the caches it writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data import memmap as mm
from repro_torch.data.pack_index import build_pack_index


def check_cache(
    cache_dir: str,
    seq_len: Optional[int] = None,
    seed: int = 0,
    epochs: Sequence[int] = (0,),
    vocab: Optional[int] = None,
) -> List[str]:
    """Returns a list of human-readable findings (empty == healthy)."""
    findings: List[str] = []
    meta_path = os.path.join(cache_dir, mm._META)
    try:
        with open(meta_path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return [f"{meta_path}: missing (not a token cache)"]
    except json.JSONDecodeError as e:
        return [f"{meta_path}: unparseable json ({e})"]
    if raw.get("magic") != mm.MAGIC:
        findings.append(f"meta.magic {raw.get('magic')!r} != {mm.MAGIC!r}")
    if raw.get("version") != mm.VERSION:
        findings.append(f"meta.version {raw.get('version')!r} != {mm.VERSION}")
    if raw.get("dtype") not in mm._DTYPES:
        findings.append(
            f"meta.dtype {raw.get('dtype')!r} not in {sorted(mm._DTYPES)}"
        )
    for key in ("n_docs", "n_tokens"):
        if not isinstance(raw.get(key), int) or raw.get(key, -1) < 0:
            findings.append(f"meta.{key} {raw.get(key)!r} is not a non-negative int")
    if findings:
        return findings

    dtype = np.dtype(raw["dtype"])
    n_docs, n_tokens = raw["n_docs"], raw["n_tokens"]

    bin_path = os.path.join(cache_dir, mm._TOKENS)
    if not os.path.exists(bin_path):
        findings.append(f"{bin_path}: missing")
    else:
        size, want = os.path.getsize(bin_path), n_tokens * dtype.itemsize
        if size != want:
            findings.append(
                f"tokens.bin truncated/corrupt: {size} bytes on disk, meta "
                f"promises {want} ({n_tokens} x {dtype.name})"
            )

    lens_path = os.path.join(cache_dir, mm._DOC_LENS)
    doc_lens = None
    if not os.path.exists(lens_path):
        findings.append(f"{lens_path}: missing")
    else:
        doc_lens = np.load(lens_path)
        if doc_lens.shape != (n_docs,):
            findings.append(f"doc_lens shape {doc_lens.shape} != ({n_docs},)")
            doc_lens = None
        elif doc_lens.size and int(doc_lens.min()) < 1:
            findings.append(f"doc_lens holds non-positive length {int(doc_lens.min())}")
        elif int(doc_lens.sum()) != n_tokens:
            findings.append(
                f"doc_lens sum {int(doc_lens.sum())} != meta.n_tokens {n_tokens}"
            )
    if findings:
        return findings

    cache = mm.TokenCache(cache_dir)
    bound = vocab if vocab is not None else raw.get("vocab")
    if bound is not None:
        # chunked scan so a huge memmap never materializes at once
        for lo in range(0, n_tokens, 1 << 22):
            c = np.asarray(cache.tokens[lo : lo + (1 << 22)])
            if c.size and (int(c.max()) >= bound or int(c.min()) < 0):
                findings.append(
                    f"token outside [0, {bound}) in stream chunk at offset {lo}"
                )
                break

    if seq_len is not None:
        for epoch in epochs:
            order = cache.epoch_order(seed, int(epoch))
            pk = build_pack_index(cache.doc_lens, cache.doc_offsets, order, seq_len)
            tag = f"pack(seed={seed}, epoch={epoch}, seq_len={seq_len})"
            if pk.piece_len.size and not (
                1 <= int(pk.piece_len.min()) and int(pk.piece_len.max()) <= seq_len
            ):
                findings.append(f"{tag}: piece length outside [1, {seq_len}]")
            if (pk.piece_off + pk.piece_len > seq_len).any():
                findings.append(f"{tag}: piece overruns its row")
            if (pk.piece_src < 0).any() or (pk.piece_src + pk.piece_len >= n_tokens).any():
                findings.append(
                    f"{tag}: piece source span outside the token stream "
                    "(targets gather from src+1)"
                )
            if pk.row_ptr[0] != 0 or pk.row_ptr[-1] != pk.n_pieces or (
                np.diff(pk.row_ptr) < 1
            ).any():
                findings.append(f"{tag}: row_ptr is not a full monotone cover")
            # first-fit writes each row contiguously: offsets are the running
            # sum of the row's piece lengths, and the fill fits the row
            for r in range(pk.n_rows):
                a, b = int(pk.row_ptr[r]), int(pk.row_ptr[r + 1])
                offs, lens = pk.piece_off[a:b], pk.piece_len[a:b]
                if offs[0] != 0 or (offs[1:] != (offs[:-1] + lens[:-1])).any():
                    findings.append(f"{tag}: row {r} is not contiguously filled")
                    break
                if int(offs[-1] + lens[-1]) > seq_len:
                    findings.append(f"{tag}: row {r} fill exceeds seq_len")
                    break
            want_live = int(np.maximum(cache.doc_lens - 1, 0).sum())
            if pk.live_tokens != want_live:
                findings.append(
                    f"{tag}: live tokens {pk.live_tokens} != trained tokens "
                    f"{want_live} (docs dropped or duplicated)"
                )
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.data.check", description=__doc__
    )
    ap.add_argument("cache_dir")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="also validate the pack index at this row length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", nargs="+", default=["0"],
                    help="epochs to validate packs for (space- or comma-separated)")
    ap.add_argument("--vocab", type=int, default=None,
                    help="token bound (defaults to meta.vocab when present)")
    args = ap.parse_args(argv)
    epochs = tuple(
        int(e) for tok in args.epochs for e in str(tok).split(",") if e.strip()
    )
    findings = check_cache(
        args.cache_dir, seq_len=args.seq_len, seed=args.seed,
        epochs=epochs or (0,), vocab=args.vocab,
    )
    for f in findings:
        print(f"# DATA: {f}", file=sys.stderr)
    if not findings:
        print(f"# token cache OK: {os.path.abspath(args.cache_dir)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
