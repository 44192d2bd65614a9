"""Port parity of the per-leaf kernels (K18-K23: kernels/vr_update.py,
vr_adam.py, vr_lamb.py, grad_stats.py) against the JAX package's per-leaf
Pallas kernels in interpret mode, and of the per-leaf VR steps built on
them (``torch_per_leaf_oracle.py``, the counterpart of tests/oracle.py's
``per_leaf_*``) against the port's flat single-launch step.

Inputs are the reference's own (``oracle.gsnr_inputs``,
``oracle.opt_state_inputs``, ``oracle.property_cases``), carried across as
numpy; the port's wrappers, given CPU tensors, compute their plain
versions.

Tolerances: the kernels ``oracle.tol_for`` of the input dtype (f32: atol
2e-5, rtol 2e-4, the per-leaf mean of r summed in another order; bf16
inputs: 3e-2), the norm sums of K20/K21 rtol 1e-5 (f32 sums of up to 7e4
terms in another order), the moment carry as test_oracle.py holds the
reference's (``tol_for``).  The per-leaf steps against the flat step: rtol
1e-4 with atol 1e-4 of the largest magnitude, the bound chip_smoke.py's
phase 12 holds them to on the card (the per-leaf sums are taken in another
order); measured here within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import torch_per_leaf_oracle as plo
from repro.kernels import grad_stats as jgs
from repro.kernels import vr_adam as jva
from repro.kernels import vr_lamb as jvl
from repro.kernels import vr_update as jvu
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, ParamLayout, pad_mask
from repro_torch.kernels import grad_stats as gs
from repro_torch.kernels import ops
from repro_torch.kernels import vr_adam as va
from repro_torch.kernels import vr_lamb as vl
from repro_torch.kernels import vr_update as vu

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread is as fast alone and
    keeps this file from oversubscribing the cores the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = ((7,), (33, 5), (3, 5, 7), (70000,))
ADAM_KW = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-8, gamma=0.1, gsnr_eps=1e-12)
LAMB_KW = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
BC = (0.19, 0.002, 0.19)
STEP_TOL = 1e-4


def _t(x, dtype=None):
    """A JAX array as a torch tensor of its own dtype (bf16 stays bf16)."""
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(torch.bfloat16) if (dtype or x.dtype) == jnp.bfloat16 else t


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), err_msg=msg,
                               **tol)


CASES = [(shape, dtype) for shape in SHAPES for dtype in oracle.DTYPES]
IDS = [f"{s}-{'f32' if d == jnp.float32 else 'bf16'}" for s, d in CASES]


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_vr_scale_matches_pallas(shape, dtype):
    for gamma, clip in ((0.1, None), (0.5, 0.37), (1.0, None)):
        g, ga, g2 = oracle.gsnr_inputs(shape, seed=sum(shape), dtype=dtype, clip_scale=clip)
        want = jvu.vr_scale(g, g2, gamma, 1e-12, g_apply=ga)
        for fn in (vu.vr_scale, vu.vr_scale_ref):
            got = fn(_t(g), _t(g2), gamma, 1e-12, g_apply=_t(ga))
            for a, b, name in zip(got, want, ("sg", "r")):
                assert a.shape == shape and a.dtype == torch.float32
                _close(a, b, oracle.tol_for(dtype), f"{fn.__name__} {name} gamma={gamma}")
        if gamma == 1.0:
            assert bool((got[1] == 1.0).all())


@pytest.mark.parametrize("case", list(oracle.property_cases(6, seed=3)),
                         ids=lambda c: str(c["shape"]))
def test_vr_scale_property_cases(case):
    g, ga, g2 = oracle.gsnr_inputs(case["shape"], case["seed"], case["dtype"], case["clip_scale"])
    want = jvu.vr_scale(g, g2, case["gamma"], 1e-12, g_apply=ga)
    got = vu.vr_scale(_t(g), _t(g2), case["gamma"], 1e-12, g_apply=_t(ga))
    for a, b in zip(got, want):
        _close(a, b, oracle.tol_for(case["dtype"]))


@pytest.mark.parametrize("shape,state_dtype", CASES, ids=IDS)
def test_vr_adam_inner_matches_pallas(shape, state_dtype):
    g, ga, g2 = oracle.gsnr_inputs(shape, seed=1, clip_scale=0.9)
    m, v, p, _ = oracle.opt_state_inputs(shape, seed=2, state_dtype=state_dtype)
    want = jva.vr_adam_inner(g, g2, m, v, p, *(jnp.float32(b) for b in BC), g_apply=ga,
                             **ADAM_KW)
    for fn in (va.vr_adam_inner, va.vr_adam_inner_ref):
        got = fn(_t(g), _t(g2), _t(m), _t(v), _t(p), *BC, g_apply=_t(ga), **ADAM_KW)
        for a, b, name in zip(got, want, ("dir", "m", "v", "p")):
            assert a.shape == shape and a.dtype == torch.float32
            _close(a, b, oracle.tol_for(state_dtype), f"{fn.__name__} {name}")


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_vr_lamb_inner_matches_pallas(shape, dtype):
    g, ga, g2 = oracle.gsnr_inputs(shape, seed=3, dtype=dtype, clip_scale=0.8)
    m, v, p, w = oracle.opt_state_inputs(shape, seed=4)
    want = jvl.vr_lamb_inner(g, ga, g2, m, v, p, w, *(jnp.float32(b) for b in BC), **LAMB_KW)
    for fn in (vl.vr_lamb_inner, vl.vr_lamb_inner_ref):
        got = fn(_t(g), _t(ga), _t(g2), _t(m), _t(v), _t(p), _t(w), *BC, **LAMB_KW)
        for a, b, name in zip(got[:4], want[:4], ("u", "m", "v", "p")):
            assert a.shape == shape
            _close(a, b, oracle.tol_for(dtype), f"{fn.__name__} {name}")
        for a, b in zip(got[4:], want[4:]):
            assert a.shape == ()
            _close(a, b, dict(rtol=1e-5, atol=0), f"{fn.__name__} norm sums")


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_vr_lars_inner_matches_pallas(shape, dtype):
    g, ga, g2 = oracle.gsnr_inputs(shape, seed=5, dtype=dtype, clip_scale=0.6)
    _, _, _, w = oracle.opt_state_inputs(shape, seed=6)
    want = jvl.vr_lars_inner(g, ga, g2, w, wd=1e-4, gamma=0.1, eps=1e-12)
    for fn in (vl.vr_lars_inner, vl.vr_lars_inner_ref):
        u, u2, w2 = fn(_t(g), _t(ga), _t(g2), _t(w), wd=1e-4, gamma=0.1, eps=1e-12)
        _close(u, want[0], oracle.tol_for(dtype), fn.__name__)
        _close(u2, want[1], dict(rtol=1e-5, atol=0))
        _close(w2, want[2], dict(rtol=1e-5, atol=0))


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_moments_carry_matches_pallas(shape, dtype):
    """k accumulations and the /k finalize on one leaf's padded carry."""
    k = 4
    jgs2d = jgs.moments_init(jnp.zeros(shape))
    jg2s2d = jnp.zeros_like(jgs2d)
    carry = gs.moments_init(torch.zeros(shape))
    assert tuple(carry.shape) == jgs2d.shape
    carries = {"kernel": (carry, carry.clone()), "plain": (carry.clone(), carry.clone())}
    for i in range(k):
        g, _, _ = oracle.gsnr_inputs(shape, seed=100 + i, dtype=dtype)
        jgs2d, jg2s2d = jgs.moments_accum(jgs2d, jg2s2d, g)
        a, b = carries["kernel"]
        assert gs.moments_accum(a, b, _t(g)) == (a, b)  # in place
        gs.moments_accum_ref(*carries["plain"], _t(g))
    for a, b in (carries["kernel"], carries["plain"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(jgs2d), rtol=0, atol=0)
        np.testing.assert_allclose(b.numpy(), np.asarray(jg2s2d), rtol=1e-6, atol=0)
    want = jgs.moments_finalize(jgs2d, jg2s2d, k, tuple(shape))
    for fn, (a, b) in ((gs.moments_finalize, carries["kernel"]),
                       (gs.moments_finalize_ref, carries["plain"])):
        got = fn(a, b, k, tuple(shape))
        for x, y in zip(got, want):
            assert x.shape == shape
            _close(x, y, oracle.tol_for(dtype), fn.__name__)


# ---- the per-leaf steps against the flat step --------------------------------


def _step_inputs(layout, seed):
    """Flat (g, ga, g2, m, v, p, w) with the zero tail the layout keeps."""
    rs = np.random.default_rng(seed)
    mask = pad_mask(layout).numpy()
    shape = mask.shape

    def f(x):
        return torch.from_numpy(np.where(mask, x, 0.0).astype(np.float32))

    g = rs.standard_normal(shape) * 0.01
    return dict(g=f(g), ga=f(g * 0.7), g2=f(g * g + rs.exponential(1e-4, shape)),
                m=f(rs.standard_normal(shape) * 1e-3), v=f(rs.exponential(1e-5, shape)),
                p=f(rs.uniform(0.1, 1.0, shape)), w=f(rs.standard_normal(shape) * 0.05))


def _assert_step(got, want, layout, what):
    """got: per-leaf list; want: flat buffer."""
    want = want.float()
    for (path, a), b in zip(zip(layout.paths, got), layout.leaf_views(want)):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL * float(want.abs().max()),
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", ["vr_scale", "vr_adam", "vr_lamb", "vr_lars"])
def test_per_leaf_steps_match_the_flat_step(name):
    tree = oracle.hostile_params(0)
    layout = ParamLayout.for_tree(tree)
    x = _step_inputs(layout, 7)
    leaves = {n: layout.leaf_views(t) for n, t in x.items()}
    stats = GradStats(mean=FlatBuffer(x["g"], layout), sq_mean=FlatBuffer(x["g2"], layout), k=8)
    grads, w = FlatBuffer(x["ga"], layout), FlatBuffer(x["w"], layout)
    lr = 3e-3
    if name == "vr_scale":
        got = plo.per_leaf_vr_scale(leaves["g"], leaves["g2"], leaves["ga"], 0.1, 1e-12)
        sg, r = ops.vr_scale_tree(stats, grads, 0.1, 1e-12)
        _assert_step([a for a, _ in got], sg.data, layout, "sg")
        _assert_step([b for _, b in got], r.data, layout, "r")
        return
    if name == "vr_lars":
        hyper = dict(mu=0.9, wd=1e-4, trust=0.001, gamma=0.1, eps=1e-12)
        state = {"step": 0, "m": leaves["m"]}
        upd, new = plo.per_leaf_vr_lars_update(leaves["ga"], state, leaves["g"], leaves["g2"],
                                                 lr, params=leaves["w"], **hyper)
        fupd, fstate = ops.vr_lars_update(grads, {"step": 0, "m": FlatBuffer(x["m"].clone(),
                                                                              layout)},
                                          stats, lr, params=w, **hyper)
        _assert_step(upd, fupd.data, layout, "upd")
        _assert_step(new["m"], fstate["m"].data, layout, "m")
        assert new["step"] == fstate["step"] == 1
        return
    kw = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
    state = {"step": 0, "pt": 0, "m": leaves["m"], "v": leaves["v"], "p": leaves["p"]}
    per_leaf = plo.per_leaf_vr_lamb_update if name == "vr_lamb" else \
        plo.per_leaf_vr_adam_update
    flat_fn = ops.vr_lamb_update if name == "vr_lamb" else ops.vr_adam_update
    upd, new = per_leaf(leaves["ga"], state, leaves["g"], leaves["g2"], lr, params=leaves["w"],
                        **kw)
    fstate = {"step": 0, "pt": 0, **{n: FlatBuffer(x[n].clone(), layout) for n in "mvp"}}
    fupd, fstate = flat_fn(grads, fstate, stats, lr, params=w, **kw)
    _assert_step(upd, fupd.data, layout, "upd")
    for n in "mvp":
        _assert_step(new[n], fstate[n].data, layout, n)
    assert (new["step"], new["pt"]) == (fstate["step"], fstate["pt"]) == (1, 1)
