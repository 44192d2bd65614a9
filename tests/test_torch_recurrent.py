"""Port parity: repro_torch.models.recurrent (the RG-LRU block) against
repro/models/recurrent.py.

Weights (the reference's init, carried across) and inputs (numpy, from a
seed) go to both sides in f32.  The port's doubling scan against the
reference's associative scan, with and without a carried state; a prefill
followed by decode steps, cache included.  Tolerance
``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4): the scans combine the
same terms in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from torch_fast_jit import fast_jit
from repro.models import recurrent as jr
from repro_torch.models import recurrent as tr

TOL = tol_for(jnp.float32)
D = 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jr.rglru_init(jax.random.PRNGKey(3), D))
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan equals the step-by-step recurrence h_t = a_t h_{t-1}
    + b_t from a carried h0 (ceil(log2 s) passes)."""
    rs = np.random.default_rng(s)
    a = torch.from_numpy(rs.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((2, s, 5)).astype(np.float32))
    h0 = torch.from_numpy(rs.standard_normal((2, 5)).astype(np.float32))
    h, want = h0, []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tr.linear_scan(a, b, h0), torch.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


def test_train_scan_matches(params):
    jp, tp = params
    x = _x(2, 21, 1)
    jout, _ = fast_jit(lambda p, xx: jr.apply_rglru(p, xx))(jp, jnp.asarray(x))
    out, cache = tr.apply_rglru(tp, torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_prefill_then_decode_matches(params):
    """A prefill of 9 tokens builds {h, conv}; four decode steps of one
    token carry it: outputs and the cache at every step."""
    jp, tp = params
    x = _x(2, 13, 2)
    jpre = fast_jit(lambda p, xx: jr.apply_rglru(p, xx, mode="prefill"))
    jdec = fast_jit(lambda p, xx, c: jr.apply_rglru(p, xx, cache=c, mode="decode"))
    jout, jc = jpre(jp, jnp.asarray(x[:, :9]))
    out, c = tr.apply_rglru(tp, torch.from_numpy(x[:, :9]), mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for t in range(9, 13):
        jout, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        out, c = tr.apply_rglru(tp, torch.from_numpy(x[:, t:t + 1]), cache=c, mode="decode")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for name in ("h", "conv"):
            assert c[name].dtype == (torch.float32)
            np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]), **TOL)
    # a decode continuing a prefill is the train scan over the whole sequence
    whole, _ = tr.apply_rglru(tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), whole[:, -1:].numpy(), **TOL)


def test_prefill_from_a_carried_state_matches(params):
    """A second prefill chunk from the first's cache folds h0 into the scan
    (the reference's virtual step 0) and continues the conv window."""
    jp, tp = params
    x = _x(2, 16, 4)
    jpre = fast_jit(lambda p, xx, c: jr.apply_rglru(p, xx, cache=c, mode="prefill"))
    _, jc = fast_jit(lambda p, xx: jr.apply_rglru(p, xx, mode="prefill"))(jp, jnp.asarray(x[:, :6]))
    jout, jc = jpre(jp, jnp.asarray(x[:, 6:]), jc)
    _, c = tr.apply_rglru(tp, torch.from_numpy(x[:, :6]), mode="prefill")
    out, c = tr.apply_rglru(tp, torch.from_numpy(x[:, 6:]), cache=c, mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(c["h"].numpy(), np.asarray(jc["h"]), **TOL)


def test_gelu_gate_is_the_tanh_form():
    """jax.nn.gelu's default (tanh) form, which the gate branch uses: equal
    to f32 rounding (atol 1e-6), where the erf form is 5.7e-5 away at -4."""
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(torch.nn.functional.gelu(x, approximate="tanh").numpy(), want,
                               rtol=1e-5, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(x).numpy() - want).max() > 5e-5
