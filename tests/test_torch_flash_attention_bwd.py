"""Port parity: repro_torch.kernels.flash_attention_bwd (the backward's plain
version) and the attention autograd Function against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs its jnp ``attention_bwd_ref``, its Pallas backward kernel in
interpret mode (as tests/test_oracle.py does) and ``jax.vjp`` of its
differentiable ``flash_attention`` (custom VJP, Pallas interpret mode); the
port's wrappers, given CPU tensors, compute their plain versions.
Tolerance: ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4) — both sides
do the same f32 math in a different summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import PACKED_ATTN_CASES, PACKED_SMOKE, packed_positions, tol_for
from repro.kernels import flash_attention as jfa
from repro.kernels import flash_attention_bwd as jfab
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab

TOL = tol_for(jnp.float32)


def _case(case, seed=0):
    """numpy (q, k, v, do, pos) for one PACKED_ATTN_CASES entry."""
    b, s, h, kvh, d, window, rows = case
    rs = np.random.default_rng(seed)
    pos = np.stack([packed_positions(s, r) for r in rows])
    q = rs.standard_normal((b, s, h, d), dtype=np.float32)
    k = rs.standard_normal((b, s, kvh, d), dtype=np.float32)
    v = rs.standard_normal((b, s, kvh, d), dtype=np.float32)
    do = rs.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, do, pos, window


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _residuals(q, k, v, do, pos, causal, window):
    """(lse, delta, q_seg) from the port's plain forward, as numpy."""
    tp = _t(pos)
    seg = fa.segment_ids_from_positions(tp)
    out, lse = fa.attention_fwd_ref(_t(q), _t(k), _t(v), causal=causal, window=window,
                                    q_pos=tp, k_pos=tp, q_seg=seg, k_seg=seg)
    delta = (_t(do) * out).sum(-1).transpose(1, 2).contiguous()
    return lse.numpy(), delta.numpy(), seg.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(PACKED_ATTN_CASES))
def test_attention_bwd_ref_matches_reference(name, causal):
    q, k, v, do, pos, window = _case(PACKED_ATTN_CASES[name])
    lse, delta, seg = _residuals(q, k, v, do, pos, causal, window)
    got = fab.flash_attention_bwd(*(_t(x) for x in (q, k, v, lse, delta, do, pos, pos, seg, seg)),
                                  causal=causal, window=window)
    want = jfab.attention_bwd_ref(
        *(jnp.asarray(x) for x in (q, k, v, lse, delta, do)), causal=causal, window=window,
        q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos), q_seg=jnp.asarray(seg),
        k_seg=jnp.asarray(seg),
    )
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n, **TOL)
    if causal and name in PACKED_SMOKE:
        kern = jfab.flash_attention_bwd(
            *(jnp.asarray(x) for x in (q, k, v, lse, delta, do, pos, pos, seg, seg)),
            causal=causal, window=window, block_q=min(jfa.DEFAULT_BLOCK_Q, q.shape[1]),
            block_k=min(jfa.DEFAULT_BLOCK_K, q.shape[1]), interpret=True,
        )
        for n, a, b in zip(("dq", "dk", "dv"), got, kern):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"kernel {n}", **TOL)
    # padded query rows reach nothing and get no gradient
    dead = pos < 0
    if dead.any():
        assert float(got[0].numpy()[dead].__abs__().max()) == 0.0


@pytest.mark.parametrize("name", PACKED_SMOKE + ("window_packed",))
def test_autograd_function_matches_jax_vjp(name):
    """(dq, dk, dv) of the port's FlashAttentionFn (its forward and backward
    wrappers; plain versions on the CPU) against jax.vjp of the reference's
    differentiable flash_attention (custom VJP, Pallas interpret mode)."""
    q, k, v, do, pos, window = _case(PACKED_ATTN_CASES[name], seed=1)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention_train(tq, tk, tv, _t(pos), _t(pos), causal=True, window=window)
    out.backward(_t(do))

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), causal=True,
                                   window=window, interpret=True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for n, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n, **TOL)


def test_autograd_function_implicit_layout_bidirectional():
    """bert's layout: implicit positions, no causal mask, MHA."""
    rs = np.random.default_rng(2)
    q, k, v, do = (rs.standard_normal((2, 48, 4, 16), dtype=np.float32) for _ in range(4))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    fa.flash_attention_train(tq, tk, tv, causal=False).backward(_t(do))
    f = lambda *a: jfa.flash_attention(*a, causal=False, interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    for n, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n, **TOL)


def test_autograd_function_is_first_order_only():
    rs = np.random.default_rng(3)
    q, k, v = (_t(rs.standard_normal((1, 8, 2, 16), dtype=np.float32)).requires_grad_(True)
               for _ in range(3))
    out = fa.flash_attention_train(q, k, v, causal=True)
    (gq,) = torch.autograd.grad(out.square().sum(), (q,), create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice|once_differentiable"):
        gq.sum().backward()


def test_fully_masked_rows_give_zero_grads():
    """A query row whose keys are all masked (lse = -1e30) must not overflow
    the recomputed p: dq is exactly 0 there and nothing reaches dk/dv."""
    rs = np.random.default_rng(5)
    b, s, h, d = 1, 12, 2, 16
    pos = np.arange(s, dtype=np.int32)[None].copy()
    pos[0, 8:] = -1
    q, k, v, do = (rs.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(4))
    lse, delta, seg = _residuals(q, k, v, do, pos, True, 0)
    assert (lse[0, :, 8:] == fa.NEG_INF).all()
    dq, dk, dv = fab.flash_attention_bwd(
        *(_t(x) for x in (q, k, v, lse, delta, do, pos, pos, seg, seg)), causal=True)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert float(dq[0, 8:].abs().max()) == 0.0
    assert float(dk[0, 8:].abs().max()) == 0.0 and float(dv[0, 8:].abs().max()) == 0.0
