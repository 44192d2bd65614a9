"""Port parity: repro_torch.models.moe against repro/models/moe.py.

Router, expert and shared-expert weights and the tokens are drawn with
numpy from a seed and handed to both sides, in f32.  The capacity-bounded
sparse path (``apply_moe``) and the oracle (``apply_moe_dense``) of each
side are held against both of the reference's, with and without capacity
drops.  Tolerances: outputs ``oracle.tol_for(float32)`` (atol 2e-5, rtol
2e-4; the same GEMMs in another order), the router's readings atol 1e-6,
gradients (of a fixed projection of the output) the same f32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from torch_fast_jit import fast_jit
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jm
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tm

TOL = tol_for(jnp.float32)
D, F = 32, 48
# (name, experts, top_k, capacity factor, shared experts, act)
CASES = {
    "top2-swiglu": (4, 2, 4.0, 0, "swiglu"),  # capacity n k: no choice is dropped
    "top1-shared": (8, 1, 8.0, 1, "swiglu"),
    "top2-gelu-drops": (4, 2, 0.5, 0, "gelu"),
    "top1-shared-drops": (8, 1, 0.3, 1, "gelu"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, seed=0):
    e, k, cf, shared, act = CASES[name]
    rs = np.random.default_rng(seed)

    def w(*shape):
        return (rs.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(D, e), "expert_wi": w(e, D, F), "expert_wd": w(e, F, D)}
    if act == "swiglu":
        p["expert_wg"] = w(e, D, F)
    for i in range(shared):
        p[f"shared_{i}"] = {"wi": w(D, F), "wd": w(F, D), **({"wg": w(D, F)} if act == "swiglu"
                                                             else {})}
    x = rs.standard_normal((3, 10, D)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, n_shared_experts=shared)
    return p, x, act, MoEConfig(**kw), JMoEConfig(**kw)


def _torch_tree(p, grad=False):
    if isinstance(p, dict):
        return {k: _torch_tree(v, grad) for k, v in p.items()}
    return torch.tensor(p, requires_grad=grad)


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_and_dense_match_the_reference(name):
    p, x, act, cfg, jcfg = _case(name)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jout, jaux = fast_jit(lambda pp, xx: jm.apply_moe(pp, xx, act, jcfg))(jp, jnp.asarray(x))
    jdense = fast_jit(lambda pp, xx: jm.apply_moe_dense(pp, xx, act, jcfg)[0])(jp, jnp.asarray(x))
    tp = _torch_tree(p)
    out, aux = tm.apply_moe(tp, torch.from_numpy(x), act, cfg)
    dense, daux = tm.apply_moe_dense(tp, torch.from_numpy(x), act, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    assert set(aux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), atol=1e-6, err_msg=key)
    for key in daux:
        np.testing.assert_allclose(float(daux[key]), float(aux[key]), atol=0, err_msg=key)
    cap = tm.capacity(x.shape[0] * x.shape[1], cfg)
    drops = CASES[name][2] < 1.0
    # without drops the sparse path is the oracle; with them some token's
    # choice lands in the sacrificial slot and reads zero
    if not drops:
        np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)
    else:
        assert cap * cfg.n_experts < x.shape[0] * x.shape[1] * cfg.top_k
        assert np.abs(out.numpy() - dense.numpy()).max() > 1e-3


@pytest.mark.parametrize("name", ["top2-swiglu", "top2-gelu-drops", "top1-shared-drops"])
def test_gradients_match_the_reference(name):
    """d/d(params, x) of sum(out * c) + the router losses, against jax.grad:
    the scatter into the expert buffer and the combine gather carry the
    gradient, and a dropped choice (the sacrificial slot) carries none."""
    p, x, act, cfg, jcfg = _case(name, seed=1)
    c = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jm.apply_moe(pp, xx, act, jcfg)
        return jnp.sum(out * c) + aux["moe_lb_loss"] + aux["moe_z_loss"]

    jg_p, jg_x = fast_jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = _torch_tree(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tm.apply_moe(tp, tx, act, cfg)
    (torch.sum(out * torch.from_numpy(c)) + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **TOL)
    for key, leaf in jax.tree_util.tree_flatten_with_path(jg_p)[0]:
        node = tp
        for k in key:
            node = node[k.key]
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(leaf), err_msg=str(key), **TOL)


def test_dropped_choices_read_zero():
    """A capacity of one slot an expert: the first token routed to an
    expert keeps it, every later choice of that expert is dropped and adds
    nothing (no shared expert here), so those tokens' outputs are zero."""
    p, x, act, cfg, _ = _case("top2-gelu-drops")
    cfg = dataclasses.replace(cfg, capacity_factor=1e-3)
    n = x.shape[0] * x.shape[1]
    assert tm.capacity(n, cfg) == 1
    out, aux = tm.apply_moe(_torch_tree(p), torch.from_numpy(x), act, cfg)
    rows = out.reshape(n, D).abs().sum(-1)
    assert int((rows > 0).sum()) <= cfg.n_experts  # at most one kept choice per expert
    assert float(aux["moe_util"]) == 1.0
