"""Port parity: repro_torch.models.xlstm (mLSTM and sLSTM) against
repro/models/xlstm.py.

Gates, queries, keys and values (or block inputs) are drawn with numpy
from a seed; block weights are the reference's init, carried across; f32
on both sides.  Tolerance ``oracle.tol_for(float32)`` (atol 2e-5, rtol
2e-4) on outputs and states: the chunkwise form sums the same terms as
the sequential one in another order, and the exponential gates amplify
no rounding beyond that at these sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from torch_fast_jit import fast_jit
from repro.models import xlstm as jx
from repro_torch.models import xlstm as tx

TOL = tol_for(jnp.float32)
D, H = 32, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_inputs(s, seed, b=2, dk=6, dv=8):
    rs = np.random.default_rng(seed)
    q, k = (rs.standard_normal((b, s, H, dk)).astype(np.float32) for _ in range(2))
    v = rs.standard_normal((b, s, H, dv)).astype(np.float32)
    ig = rs.standard_normal((b, s, H)).astype(np.float32)
    fg = np.log(1 / (1 + np.exp(-(rs.standard_normal((b, s, H)) + 3)))).astype(np.float32)
    return q, k, v, ig, fg


def _state(seed, b=2, dk=6, dv=8):
    """A carried state (C, n, m) as a prefix of a sequence would leave it."""
    q, k, v, ig, fg = _cell_inputs(5, seed, b, dk, dv)
    _, st = jx.mlstm_sequential(*(jnp.asarray(a) for a in (q, k, v, ig, fg)))
    return tuple(np.array(a) for a in st)


def _np(tree):
    return tuple(t.numpy() for t in tree)


def _check(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_mlstm_chunkwise_matches(chunk, carried):
    """Chunks of 4 and 8 over 19 steps (a padded tail: ig = -1e30) and one
    chunk longer than the sequence, from zero or a carried state: the
    port's chunkwise form against the reference's, and against the
    sequential oracle."""
    ins = _cell_inputs(19, chunk)
    st = _state(7) if carried else None
    jst = None if st is None else tuple(jnp.asarray(a) for a in st)
    jh, jfin = fast_jit(lambda *a: jx.mlstm_chunkwise(*a[:5], a[5], chunk=chunk))(
        *(jnp.asarray(a) for a in ins), jst)
    tst = None if st is None else tuple(torch.from_numpy(a) for a in st)
    h, fin = tx.mlstm_chunkwise(*(torch.from_numpy(a) for a in ins), tst, chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    _check(_np(fin), jfin)
    hs, sfin = tx.mlstm_sequential(*(torch.from_numpy(a) for a in ins), tst)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), **TOL)
    _check(_np(fin), sfin)


def test_mlstm_sequential_matches():
    ins = _cell_inputs(6, 3)
    st = _state(8)
    jh, jfin = fast_jit(jx.mlstm_sequential)(*(jnp.asarray(a) for a in ins),
                                             tuple(jnp.asarray(a) for a in st))
    h, fin = tx.mlstm_sequential(*(torch.from_numpy(a) for a in ins),
                                 tuple(torch.from_numpy(a) for a in st))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    _check(_np(fin), jfin)


def _block(kind, seed=0):
    key = jax.random.PRNGKey(seed)
    jp = (jx.mlstm_init(key, D, H) if kind == "mlstm" else jx.slstm_init(key, D, H))
    jp = jax.device_get(jp)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _apply(kind):
    """(JAX apply, port apply -> block output): the port's block returns
    the hidden state before its down projection (models/transformer.py
    multiplies), the reference's the output."""
    if kind == "mlstm":
        def port(p, x, **kw):
            hid, c = tx.apply_mlstm(p, x, H, **kw)
            return hid @ p["xl_down"], c
        return (lambda p, x, c=None, mode="train":
                jx.apply_mlstm(p, x, H, cache=c, mode=mode)), port

    def port(p, x, **kw):
        hid, c = tx.apply_slstm(p, x, H, **kw)
        return hid @ p["sl_down"], c
    return (lambda p, x, c=None, mode="train": jx.apply_slstm(p, x, H, cache=c, mode=mode)), port


def _tree_close(got, want, path=""):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _tree_close(a, b, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=path, **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_then_decode_matches(kind):
    """The block on 11 tokens in train mode, then a prefill of 8 and three
    single-token decode steps (the mLSTM's decode is the sequential cell):
    outputs and the caches ({"conv", "state"}, states as tuples)."""
    jp, tp = _block(kind)
    japply, tapply = _apply(kind)
    x = np.random.default_rng(11).standard_normal((2, 11, D)).astype(np.float32)
    # the train and prefill calls share one compile
    both = fast_jit(lambda p, xx, x8: (japply(p, xx), japply(p, x8, mode="prefill")))
    (jout, _), (jpre, jc) = both(jp, jnp.asarray(x), jnp.asarray(x[:, :8]))
    out, c = tapply(tp, torch.from_numpy(x))
    assert c is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    out, c = tapply(tp, torch.from_numpy(x[:, :8]), mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jpre), **TOL)
    jdec = fast_jit(lambda p, xx, cc: japply(p, xx, cc, mode="decode"))
    for t in range(8, 11):
        jout, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        out, c = tapply(tp, torch.from_numpy(x[:, t:t + 1]), cache=c, mode="decode")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        _tree_close(c, jc)


def test_slstm_keeps_its_f32_leaves():
    """sl_r, sl_b and xl_if_b enter in f32 whatever the compute dtype."""
    _, tp = _block("slstm")
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 5, D)).astype(np.float32))
    h32, c32 = tx.apply_slstm(tp, x, H, mode="prefill")
    h16, c16 = tx.apply_slstm(tp, x.to(torch.bfloat16), H, mode="prefill")
    assert h16.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in c16["state"])
    assert float((h16.float() - h32).abs().max()) < 0.1
