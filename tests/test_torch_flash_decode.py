"""Port parity: repro_torch.kernels.flash_decode against the JAX package.

The paged cache is arrival-ordered with two interleaved documents per row
and empty slots past the fill cursor; query lanes continue one document
each.  The JAX side runs its decode kernel in interpret mode and the jnp
paged oracle.  Tolerance: ``oracle.tol_for(float32)`` for f32 (same math,
different summation order); ``tol_for(bfloat16)`` for the bf16 run (bf16
inputs, f32 math on both sides, bf16 output rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from repro.kernels import ref
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro_torch.kernels import flash_decode as fd

TOL = tol_for(jnp.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread is as fast alone and
    keeps this file from oversubscribing the cores the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged_case(b, c, lanes, kvh, g, d, n_fill, seed=0):
    rs = np.random.default_rng(seed)
    k = rs.standard_normal((b, c, kvh, d), dtype=np.float32)
    v = rs.standard_normal((b, c, kvh, d), dtype=np.float32)
    q = rs.standard_normal((b, lanes, kvh * g, d), dtype=np.float32)
    k_pos = np.full((b, c), -1, np.int32)
    k_seg = np.full((b, c), -1, np.int32)
    counts = np.zeros((b, 2), np.int32)
    for bi in range(b):
        for s in range(n_fill):
            seg = int(rs.integers(0, 2))
            k_seg[bi, s], k_pos[bi, s] = seg, counts[bi, seg]
            counts[bi, seg] += 1
    q_seg = np.broadcast_to(np.arange(lanes, dtype=np.int32) % 2, (b, lanes)).copy()
    q_pos = counts[np.arange(b)[:, None], q_seg].astype(np.int32)
    return q, k, v, q_pos, k_pos, q_seg, k_seg


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_matches_pallas_kernel(lanes, window):
    case = _paged_case(b=2, c=48, lanes=lanes, kvh=2, g=2, d=32, n_fill=30, seed=lanes)
    out = fd.flash_decode(*_torch(*case), causal=True, window=window).numpy()
    jcase = [jnp.asarray(a) for a in case]
    j_out = np.asarray(j_flash_decode(*jcase, causal=True, window=window, interpret=True))
    r_out = np.asarray(ref.decode_attention_ref(*jcase, causal=True, window=window))
    assert out.shape == case[0].shape
    np.testing.assert_allclose(out, j_out, **TOL)
    np.testing.assert_allclose(out, r_out, **TOL)


@pytest.mark.parametrize("g", [1, 4], ids=["mha", "gqa"])
def test_decode_mqa_gqa_match_oracle(g):
    q, k, v, q_pos, k_pos, q_seg, k_seg = _paged_case(b=3, c=40, lanes=2, kvh=1 if g == 4 else 2,
                                                       g=g, d=16, n_fill=33, seed=7)
    out = fd.flash_decode(*_torch(q, k, v, q_pos, k_pos, q_seg, k_seg)).numpy()
    r_out = ref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos, q_seg, k_seg)))
    np.testing.assert_allclose(out, np.asarray(r_out), **TOL)


def test_idle_lanes_and_empty_slots():
    """Idle lanes give exactly 0; empty slots never contribute (a cache with
    extra empty slots matches a tight one)."""
    q, k, v, q_pos, k_pos, q_seg, k_seg = _paged_case(b=1, c=40, lanes=4, kvh=1, g=2, d=16,
                                                       n_fill=24, seed=4)
    q_pos[0, 2] = q_seg[0, 2] = -1
    out = fd.flash_decode(*_torch(q, k, v, q_pos, k_pos, q_seg, k_seg)).numpy()
    assert np.all(out[0, 2] == 0.0)
    tight = fd.flash_decode(*_torch(q, k[:, :24], v[:, :24], q_pos, k_pos[:, :24], q_seg,
                                    k_seg[:, :24])).numpy()
    np.testing.assert_allclose(out, tight, atol=1e-6)


def test_bf16_matches_pallas_kernel():
    case = list(_paged_case(b=2, c=48, lanes=3, kvh=2, g=2, d=32, n_fill=30, seed=5))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in case[:3])
    out = fd.flash_decode(tq, tk, tv, *_torch(*case[3:]), causal=True)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in case[:3])
    j_out = j_flash_decode(jq, jk, jv, *(jnp.asarray(a) for a in case[3:]), causal=True,
                           interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32),
                               **tol_for(jnp.bfloat16))


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("lanes", [1, 4])
def test_split_and_combine_plain_versions_compose(chunk, lanes):
    """The plain per-chunk partials (m, l, acc) merged by the plain combine
    equal the one-pass decode — the split arithmetic that the CUDA kernel
    performs inside a cluster, held against the JAX oracle."""
    case = _paged_case(b=2, c=150, lanes=lanes, kvh=2, g=2, d=32, n_fill=100, seed=chunk + lanes)
    case[3][0, -1] = case[5][0, -1] = -1  # an idle lane
    tq, tk, tv, tqp, tkp, tqs, tks = _torch(*case)
    m, l, acc = fd.decode_split_ref(tq, tk, tv, tqp, tkp, tqs, tks, causal=True, window=0,
                                    chunk=chunk)
    ns = -(-150 // chunk)
    assert m.shape == (2, 4, lanes, ns) and acc.shape == (2, 4, lanes, ns, 32)
    out = fd.decode_combine_ref(m, l, acc, torch.float32).numpy()
    r_out = ref.decode_attention_ref(*(jnp.asarray(a) for a in case), causal=True)
    np.testing.assert_allclose(out, np.asarray(r_out), **TOL)
    assert np.all(out[0, -1] == 0.0)


@pytest.mark.parametrize("b,kvh,rows,c", [(8, 8, 2, 552), (8, 8, 8, 552), (1, 1, 1, 40),
                                          (2, 8, 32, 4096), (64, 8, 2, 552)])
def test_split_plan_covers_the_sms_twice(b, kvh, rows, c):
    """The cluster plan: at most 8 splits (a cluster's blocks), each chunk a
    whole number of tiles, the chunks covering C exactly, and the SMs
    covered twice, unless the splits are already 8 or each is one tile.
    Where B * KV alone fills the card twice, the cluster is one block."""
    tile, chunk, ns = fd.split_plan(b, kvh, rows, c, n_sm=132)
    assert tile in fd.TILES and 1 <= ns <= fd.MAX_SPLITS
    assert chunk % tile == 0 and ns == -(-c // chunk) and (ns - 1) * chunk < c <= ns * chunk
    blocks = b * kvh * -(-rows // fd.ROWS_PER_BLOCK) * ns
    assert blocks >= 2 * 132 or chunk == tile or ns == fd.MAX_SPLITS
    if b * kvh >= 2 * 132:
        assert ns == 1


def test_requires_explicit_operands():
    q = torch.zeros(1, 1, 2, 16)
    k = v = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="required"):
        fd.flash_decode(q, k, v, None, torch.zeros(1, 8, dtype=torch.int32), None, None)

