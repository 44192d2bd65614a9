"""Port parity of the data path (repro_torch.data) against the JAX package's
(repro.data): the synthetic generators, sequence packing, the pack index,
the token cache, the indexed dataset and the cache validator.

Everything here is numpy on both sides, seeded the same way, so the port
must agree with the reference byte for byte: arrays are compared with
``np.array_equal`` and their dtypes, cache files as bytes.  The case grids
are the reference's own (tests/test_memmap.py: the hostile pack-index
lengths and the Markov stream)."""
import json
import os

import numpy as np
import pytest
import torch

import repro.data as jd
from repro.data import check as j_check
from repro_torch import data as td
from repro_torch.data import check as t_check


def _equal(a, b, what=""):
    """Two batches (dicts of arrays) with the same keys, dtypes and bytes."""
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype)
        assert np.array_equal(x, y), (what, k)


def _docs(vocab=64, total=4000, min_doc=3, max_doc=70, stream_seed=1):
    return list(td.markov_documents(vocab, total, min_doc, max_doc, seed=0,
                                    stream_seed=stream_seed))


def _cache(path, docs, vocab=64, pkg=td, dtype=np.int32):
    pkg.write_token_cache(docs, str(path), vocab=vocab, dtype=dtype)
    return str(path)


# ---------------------------------------------------------------------------
# the synthetic generators
# ---------------------------------------------------------------------------


def test_generators_are_byte_identical():
    a, b = jd.markov_documents(97, 3000, 2, 40, seed=3, stream_seed=5), \
        td.markov_documents(97, 3000, 2, 40, seed=3, stream_seed=5)
    da, db = list(a), list(b)
    assert len(da) == len(db) and all(np.array_equal(x, y) and x.dtype == y.dtype
                                      for x, y in zip(da, db))
    for args in ((64, 4, 32), (100, 3, 48, 2, 7, 5, 20)):
        ja, ta = jd.packed_lm_batches(*args), td.packed_lm_batches(*args)
        for _ in range(3):
            _equal(next(ja), next(ta), f"packed_lm_batches{args}")
    xa, ya = jd.classification_data(300, dim=16, classes=5, seed=2, sample_seed=4)
    xb, yb = td.classification_data(300, dim=16, classes=5, seed=2, sample_seed=4)
    _equal({"x": xa, "y": ya}, {"x": xb, "y": yb}, "classification_data")
    ca, cb = jd.classification_batches(xa, ya, 32, seed=1), td.classification_batches(xb, yb, 32,
                                                                                      seed=1)
    for _ in range(3):
        _equal(next(ca), next(cb), "classification_batches")
    ra, rb = jd.ctr_batches(16, 1 << 10, 5, seed=1, stream_seed=2), \
        td.ctr_batches(16, 1 << 10, 5, seed=1, stream_seed=2)
    for _ in range(3):
        _equal(next(ra), next(rb), "ctr_batches")
    for kw in ({}, {"noise": 0.3, "anisotropy": 2.0}):
        xa, ya = jd.linreg_data(50, seed=7, **kw)
        xb, yb = td.linreg_data(50, seed=7, **kw)
        _equal({"x": xa, "y": ya}, {"x": xb, "y": yb}, f"linreg_data {kw}")


def test_pack_sequences_is_byte_identical():
    rng = np.random.RandomState(0)
    pairs = []
    for n in [2, 1, 30, 5, 31, 2, 32, 7, 3, 16, 17, 0, 9]:
        t = rng.randint(0, 50, size=n + 1)
        pairs.append((t[:-1], t[1:]))
    _equal(jd.pack_sequences(pairs, 32), td.pack_sequences(pairs, 32), "pack_sequences")
    _equal(jd.pack_sequences([], 8, pad_id=3), td.pack_sequences([], 8, pad_id=3), "empty")
    with pytest.raises(ValueError, match="exceeds"):
        td.pack_sequences([(np.zeros(9), np.zeros(9))], 8)


# ---------------------------------------------------------------------------
# the pack index, on the reference's case grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "lens, seq_len",
    [
        ([2, 1, 33, 5, 97, 2, 64, 1, 130, 7, 3, 65, 33, 2], 32),
        ([200, 2, 200, 3, 199], 64),
        ([2] * 40 + [9] * 7, 8),
        ([17, 16, 15, 18, 16, 2, 16], 16),
    ],
)
def test_pack_index_and_gather_match_the_reference(tmp_path, lens, seq_len):
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 64, size=n).astype(np.int32) for n in lens]
    cache = td.TokenCache(_cache(tmp_path / "c", docs))
    for seed, epoch in [(0, 0), (0, 1), (5, 2)]:
        order = cache.epoch_order(seed, epoch)
        got = td.build_pack_index(cache.doc_lens, cache.doc_offsets, order, seq_len)
        want = jd.build_pack_index(cache.doc_lens, cache.doc_offsets, order, seq_len)
        for f in ("piece_row", "piece_off", "piece_seg", "piece_src", "piece_len", "row_ptr"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (got.n_rows, got.live_tokens, got.pack_efficiency) == \
            (want.n_rows, want.live_tokens, want.pack_efficiency)
        for lo, hi, pad in ((0, got.n_rows, None), (0, 1, 3), (got.n_rows - 1, got.n_rows, 4)):
            _equal(td.gather_rows(got, cache.tokens, lo, hi, pad_to=pad),
                   jd.gather_rows(want, cache.tokens, lo, hi, pad_to=pad), f"rows {lo}:{hi}")


def test_pack_index_on_the_markov_stream(tmp_path):
    cache = td.TokenCache(_cache(tmp_path / "c", _docs()))
    order = cache.epoch_order(0, 0)
    got = td.build_pack_index(cache.doc_lens, cache.doc_offsets, order, 32)
    want = jd.build_pack_index(cache.doc_lens, cache.doc_offsets, order, 32)
    _equal(td.gather_rows(got, cache.tokens, 0, got.n_rows),
           jd.gather_rows(want, cache.tokens, 0, want.n_rows), "markov")
    with pytest.raises(ValueError, match="outside"):
        td.gather_rows(got, cache.tokens, 0, got.n_rows + 1)


# ---------------------------------------------------------------------------
# the token cache and the indexed dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_cache_files_are_byte_identical(tmp_path, dtype):
    docs = _docs(total=1500)
    a = _cache(tmp_path / "port", docs, pkg=td, dtype=dtype)
    b = _cache(tmp_path / "ref", docs, pkg=jd, dtype=dtype)
    for name in ("tokens.bin", "doc_lens.npy", "meta.json"):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert td.load_meta(a) == jd.load_meta(b)
    with pytest.raises(ValueError, match="outside"):
        td.write_token_cache([np.array([99])], str(tmp_path / "bad"), vocab=16)
    with pytest.raises(ValueError, match="empty"):
        td.write_token_cache([np.array([], np.int32)], str(tmp_path / "bad2"))


def test_dataset_batches_resume_and_epochs_match_the_reference(tmp_path):
    d = _cache(tmp_path / "c", _docs(total=1500))
    rows = 4
    tds, jds = td.IndexedPackedDataset(d, 32, rows, seed=3), jd.IndexedPackedDataset(d, 32, rows,
                                                                                     seed=3)
    n_rows = tds.pack_for(0).n_rows
    n_batches = (2 * n_rows) // rows + 3  # crosses two epoch boundaries
    for i in range(n_batches):
        _equal(tds.next_batch(), jds.next_batch(), f"batch {i}")
    assert int(tds.state.epoch) >= 2
    # a ragged request that spans an epoch boundary
    _equal(tds.next_batch(n_rows - 1), jds.next_batch(n_rows - 1), "spanning")
    assert tds.state == jds.state and tds.last_pack_efficiency == jds.last_pack_efficiency
    # mid-epoch resume from the reference's cursor
    cut = n_rows // rows // 2 + 1
    ref = jd.IndexedPackedDataset(d, 32, rows, seed=3)
    for _ in range(cut):
        ref.next_batch()
    st = ref.state
    assert int(st.row) not in (0, n_rows)
    resumed = td.IndexedPackedDataset(d, 32, rows, state=td.DataState.make(*map(int, st)))
    for i in range(cut, n_batches):
        _equal(resumed.next_batch(), ref.next_batch(), f"resumed batch {i}")
    # eval passes: padded, finite, and they leave the cursor alone
    before = tds.state
    ta, ja = list(tds.epoch_batches(rows=5)), list(jds.epoch_batches(rows=5))
    assert len(ta) == len(ja) == -(-n_rows // 5)
    for i, (a, b) in enumerate(zip(ta, ja)):
        _equal(a, b, f"eval batch {i}")
    assert tds.state == before and tds.epoch_stats[0] == jds.epoch_stats[0]


def test_prefetched_iter_state_tracks_consumption(tmp_path):
    d = _cache(tmp_path / "c", _docs(total=1200))
    ds = td.IndexedPackedDataset(d, 32, 4, seed=1)
    ref = jd.IndexedPackedDataset(d, 32, 4, seed=1)
    for device in (False, "cpu"):
        it = ds.iter_batches(prefetch_size=2, device=device)
        try:
            for i in range(5):
                b = next(it)
                if device:
                    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                               for v in b.values())
                    b = {k: v.numpy() for k, v in b.items()}
                _equal(b, ref.next_batch(), f"{device} batch {i}")
                # .state is the cursor after THIS batch, not the producer's
                assert (int(it.state.epoch), int(it.state.row)) == \
                    (int(ref.state.epoch), int(ref.state.row))
        finally:
            it.close()
        ds = td.IndexedPackedDataset(d, 32, 4, state=it.state)
    _equal(ds.next_batch(), ref.next_batch(), "resumed from the tracked state")
    sync = td.IndexedPackedDataset(d, 32, 4, seed=1).iter_batches(device="cpu")
    _equal({k: v.numpy() for k, v in next(sync).items()},
           jd.IndexedPackedDataset(d, 32, 4, seed=1).next_batch(), "synchronous placement")


def test_prefetch_helpers_place_and_propagate_errors():
    batches = [{"x": np.arange(6, dtype=np.int32).reshape(2, 3) + i} for i in range(3)]
    got = list(td.device_prefetch(iter(batches), size=2, device="cpu"))
    assert [torch.equal(g["x"], torch.from_numpy(b["x"])) for g, b in zip(got, batches)] == \
        [True] * 3
    got = list(td.device_stream(iter(batches), device="cpu"))
    assert len(got) == 3 and all(isinstance(g["x"], torch.Tensor) for g in got)
    assert td.host_slice(batches[0], 1, 2)["x"].tolist() == [[3, 4, 5]]

    def broken():
        yield batches[0]
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(td.prefetch(broken(), size=1))


# ---------------------------------------------------------------------------
# the cache validator and its CLI
# ---------------------------------------------------------------------------


def _break(d, how):
    if how == "truncated":
        path = os.path.join(d, "tokens.bin")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 8)
    elif how == "meta_dtype":
        path = os.path.join(d, "meta.json")
        meta = json.load(open(path))
        json.dump(dict(meta, dtype="float64"), open(path, "w"))
    elif how == "lens_sum":
        lens = np.load(os.path.join(d, "doc_lens.npy"))
        lens[0] += 3
        np.save(os.path.join(d, "doc_lens.npy"), lens)
    elif how == "out_of_vocab":
        dtype = np.dtype(json.load(open(os.path.join(d, "meta.json")))["dtype"])
        mm = np.memmap(os.path.join(d, "tokens.bin"), dtype=dtype, mode="r+")
        mm[5] = 9999
        mm.flush()
        del mm


@pytest.mark.parametrize("how", ["healthy", "truncated", "meta_dtype", "lens_sum",
                                 "out_of_vocab"])
def test_check_cache_findings_match_the_reference(tmp_path, how, capsys):
    d = _cache(tmp_path / "c", _docs(total=900))
    _break(d, how)
    kw = dict(seq_len=32, epochs=(0, 1)) if how == "healthy" else {}
    got, want = t_check.check_cache(d, **kw), j_check.check_cache(d, **kw)
    assert got == want
    assert (got == []) == (how == "healthy")
    argv = [d, "--seq-len", "32"] if how == "healthy" else [d]
    assert t_check.main(argv) == j_check.main(argv) == (0 if how == "healthy" else 1)
    err = capsys.readouterr().err
    assert ("# DATA:" in err) == (how != "healthy")
