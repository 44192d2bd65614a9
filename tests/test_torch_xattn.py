"""Port parity: cross-attention (models/attention.py with ``memory``) and
the whisper encoder (models/transformer.py::encode) against the JAX
package.

Projections (the reference's init, carried across), queries and memory
(numpy, from a seed) go to both sides in f32.  The port's plain path and
its fused path (the kernel wrappers, which compute their plain versions
on the CPU: the attention autograd Function with Sq != Skv, explicit
all-zero segments) are held against the reference's jnp path; so are the
gradients, the cross cache built at prefill and the decode that reads it.
Memory positions below 0 (padding) are masked on the k side.  Tolerance
``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from torch_fast_jit import fast_jit
from repro.backend import Backend as JBackend
from repro.configs import get_smoke as j_get_smoke
from repro.models import attention as ja
from repro.models import transformer as jt
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.train.checkpoint import params_from_numpy

TOL = tol_for(jnp.float32)
D, H, KV, HD = 32, 4, 2, 8
M = 13  # memory length: no multiple of the kernels' 64-row tiles


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax.device_get(ja.attn_init(jax.random.PRNGKey(4), D, H, KV, HD))
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _inputs(s, seed, mem_pads=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((2, s, D)).astype(np.float32)
    mem = rs.standard_normal((2, M, D)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    mem_pos = np.broadcast_to(np.arange(M, dtype=np.int32), (2, M)).copy()
    if mem_pads:
        mem_pos[1, -mem_pads:] = -1
    return x, mem, q_pos, mem_pos


def _common(plan):
    return dict(n_heads=H, n_kv_heads=KV, head_dim=HD, backend=plan)


@pytest.mark.parametrize("mem_pads", [0, 4])
@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_cross_attention_train_and_grads_match(plan, mem_pads, weights):
    """Train mode: output, and the gradients of sum(out * c) with respect
    to x, the memory and the projections."""
    jp, tp = weights
    x, mem, q_pos, mem_pos = _inputs(9, 1, mem_pads)
    c = np.random.default_rng(2).standard_normal((2, 9, D)).astype(np.float32)

    def jloss(p, xx, mm):
        out, _ = ja.attention(p, xx, q_pos=jnp.asarray(q_pos), memory=mm,
                              mem_pos=jnp.asarray(mem_pos), **_common(JBackend.all_reference()))
        return jnp.sum(out * c), out

    (_, jout), jg = fast_jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(mem))
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    tm = torch.tensor(mem, requires_grad=True)
    out, cache = ta.attention(tpg, tx, q_pos=torch.from_numpy(q_pos), memory=tm,
                              mem_pos=torch.from_numpy(mem_pos), **_common(tb))
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    torch.sum(out * torch.from_numpy(c)).backward()
    jgp, jgx, jgm = jg
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgm), **TOL)
    for k in jgp:
        np.testing.assert_allclose(tpg[k].grad.numpy(), np.asarray(jgp[k]), err_msg=k, **TOL)
    if mem_pads:  # padded memory rows take no gradient
        assert float(tm.grad[1, -mem_pads:].abs().max()) == 0.0


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_cross_cache_prefill_and_decode_match(plan, weights):
    """Prefill builds the cross cache {k, v, kpos} from the memory; decode
    steps read it (the plain path: the reference has no kernel there)."""
    jp, tp = weights
    x, mem, q_pos, _ = _inputs(6, 3)
    jb = JBackend.all_reference()
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    jout, jc = ja.attention(jp, jnp.asarray(x), q_pos=jnp.asarray(q_pos), memory=jnp.asarray(mem),
                            mode="prefill", **_common(jb))
    out, c = ta.attention(tp, torch.from_numpy(x), q_pos=torch.from_numpy(q_pos),
                          memory=torch.from_numpy(mem), mode="prefill", **_common(tb))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert set(c) == set(jc) == {"k", "v", "kpos"}
    np.testing.assert_array_equal(c["kpos"].numpy(), np.asarray(jc["kpos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]), **TOL)
    for t in range(2):
        xt = np.random.default_rng(10 + t).standard_normal((2, 1, D)).astype(np.float32)
        pos = np.full((2, 1), 6 + t, np.int32)
        jout, jc = ja.attention(jp, jnp.asarray(xt), q_pos=jnp.asarray(pos),
                                memory=jnp.asarray(mem), cache=jc, mode="decode", **_common(jb))
        out, c = ta.attention(tp, torch.from_numpy(xt), q_pos=torch.from_numpy(pos),
                              memory=torch.from_numpy(mem), cache=c, mode="decode", **_common(tb))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.fixture(scope="module")
def encoded():
    """(the whisper smoke's port params, frames, the reference's encoder
    output on them)."""
    jcfg = j_get_smoke("whisper-small")
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, compute_dtype="float32",
                                                     backend=JBackend.all_reference()))
    m = jcfg.model
    jp = fast_jit(lambda key: jt.init_params(m, key))(jax.random.PRNGKey(1))
    frames = np.random.default_rng(5).standard_normal((2, m.encoder.n_frames, m.d_model))
    frames = frames.astype(np.float32)
    want = fast_jit(lambda p, f: jt.encode(m, jcfg.parallel, p, f))(jp, jnp.asarray(frames))
    return params_from_numpy(jax.device_get(jp), get_smoke("whisper-small").model), frames, want


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_encode_matches(plan, encoded):
    """The whisper smoke's encoder (2 non-causal attn blocks over 16
    frames, the final norm), on both of the port's plans."""
    tp, frames, want = encoded
    tcfg = get_smoke("whisper-small")
    tb = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    tcfg = tcfg.replace(parallel=dataclasses.replace(tcfg.parallel, compute_dtype="float32",
                                                     backend=tb))
    got = tt.encode(tcfg.model, tcfg.parallel, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
