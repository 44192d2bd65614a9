"""Port parity: repro_torch.kernels.flash_attention against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs the Pallas kernel in interpret mode (as tests/test_oracle.py does)
and the jnp reference; the port's wrapper, given CPU tensors, computes its
plain version.  Tolerance: ``oracle.tol_for(float32)`` (atol 2e-5, rtol
2e-4) — both sides do the same f32 math in a different summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import PACKED_ATTN_CASES, PACKED_SMOKE, packed_positions, tol_for
from repro.kernels import ref
from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as fa

TOL = tol_for(jnp.float32)


def _qkv(b, sq, skv, h, kvh, d, seed=0):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rs.standard_normal((b, skv, kvh, d), dtype=np.float32)
    v = rs.standard_normal((b, skv, kvh, d), dtype=np.float32)
    return q, k, v


def _jax_kernel_with_lse(q, k, v, q_pos, k_pos, causal, window):
    """The Pallas forward kernel (interpret mode) with its LSE output."""
    qp, kp, qs, ks = jfa.resolve_positions(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                           q.shape[1], k.shape[1])
    bq, bk = min(jfa.DEFAULT_BLOCK_Q, q.shape[1]), min(jfa.DEFAULT_BLOCK_K, k.shape[1])
    out, lse = jfa._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qp, kp, qs, ks,
        causal=causal, window=window, block_q=bq, block_k=bk, interpret=True,
        with_lse=True, implicit=False,
    )
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("name", list(PACKED_SMOKE) + ["window_packed"])
def test_packed_cases_match_pallas_kernel(name):
    b, s, h, kvh, d, window, rows = PACKED_ATTN_CASES[name]
    q, k, v = _qkv(b, s, s, h, kvh, d, seed=1)
    pos = np.stack([packed_positions(s, r) for r in rows])
    out, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos), torch.from_numpy(pos),
                                  causal=True, window=window, with_lse=True)
    j_out, j_lse = _jax_kernel_with_lse(q, k, v, pos, pos, True, window)
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, **TOL)
    r_out, r_lse = ref.attention_fwd_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=True, window=window,
                                         q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(r_lse), **TOL)


@pytest.mark.parametrize(
    "b,s,h,kvh,d,causal,window",
    [
        (2, 64, 4, 2, 32, True, 0),  # GQA
        (1, 48, 4, 1, 64, True, 0),  # MQA
        (2, 40, 4, 4, 16, False, 0),  # MHA, bidirectional
        (1, 64, 6, 3, 32, True, 9),  # GQA, sliding window
    ],
    ids=["gqa", "mqa", "mha_bidir", "gqa_window"],
)
def test_implicit_layout_matches_pallas_kernel(b, s, h, kvh, d, causal, window):
    q, k, v = _qkv(b, s, s, h, kvh, d, seed=2)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, window=window)
    j_out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


def test_fully_masked_rows_are_exact_zero():
    """Padding rows and window-starved rows: exactly 0 and lse -1e30 on both
    sides (not the uniform average of a clamped softmax)."""
    b, sq, skv, h, kvh, d = 1, 24, 16, 4, 2, 16
    q, k, v = _qkv(b, sq, skv, h, kvh, d, seed=3)
    q_pos = np.arange(sq, dtype=np.int32)[None] + 20  # rows 20.. see no key in window 4
    q_pos[0, :5] = -1  # padding rows
    k_pos = np.arange(skv, dtype=np.int32)[None]
    segs_q = np.zeros_like(q_pos)
    segs_k = np.zeros_like(k_pos)
    out, lse = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos), torch.from_numpy(segs_q),
        torch.from_numpy(segs_k), causal=True, window=4, with_lse=True)
    r_out, r_lse = ref.attention_fwd_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=4,
        q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
        q_seg=jnp.asarray(segs_q), k_seg=jnp.asarray(segs_k))
    dead = np.ones((b, sq), bool)  # every row: pads, or positions >= 20 past the window
    assert np.all(out.numpy()[dead] == 0.0) and np.all(np.asarray(r_out)[dead] == 0.0)
    assert np.all(lse.numpy() == fa.NEG_INF) and np.all(np.asarray(r_lse) == -1e30)
    # one live row mixed in: only it is nonzero
    q_pos[0, 7] = 15
    out = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos), torch.from_numpy(segs_q),
        torch.from_numpy(segs_k), causal=True, window=4).numpy()
    r_out = np.asarray(ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=4,
        q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
        q_seg=jnp.asarray(segs_q), k_seg=jnp.asarray(segs_k)))
    np.testing.assert_allclose(out, r_out, **TOL)
    assert np.abs(out[0, 7]).max() > 0 and np.all(np.delete(out[0], 7, axis=0) == 0.0)


def test_segment_ids_from_positions_exact():
    rs = np.random.default_rng(4)
    rows = []
    for _ in range(5):
        docs = [(int(rs.integers(1, 30)), int(rs.integers(0, 3)) * 7) for _ in range(4)]
        rows.append(packed_positions(130, docs))
    pos = np.stack(rows)
    got = fa.segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    want = np.asarray(jfa.segment_ids_from_positions(jnp.asarray(pos)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_resolve_positions_contract():
    with pytest.raises(ValueError, match="together"):
        fa.resolve_positions(torch.zeros(1, 4, dtype=torch.int32), None, 4, 4)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa.resolve_positions(None, None, 4, 6)
    qp, kp, qs, ks = fa.resolve_positions(None, None, 5, 5)
    assert qp.tolist() == [[0, 1, 2, 3, 4]] and qs.tolist() == [[0] * 5] and ks is qs

