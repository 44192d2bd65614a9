"""Port parity: repro_torch.core.layout and the flat kernels' plain versions
(kernels/flat_stats.py, kernels/flat_update.py) against the JAX package.

Inputs are made with numpy from a seed (or by the reference's own
``oracle.hostile_params`` tree) and handed to both sides.  The JAX side runs
its Pallas kernels in interpret mode (as tests/test_oracle.py does); the
port's wrappers, given CPU tensors, compute their plain versions.

Tolerances: layout geometry, packing, Σg and the finalize are exact (the
same f32 additions element by element; the finalize multiplies by the same
f32 1/k).  Σg² is within rtol 1e-6: XLA may fuse g*g + s into one FMA where
the plain version rounds the product first (one rounding apart).  The VR-LAMB update uses ``oracle.tol_for(float32)``
(atol 2e-5, rtol 2e-4): its per-leaf sums of r, u^2 and w^2 run in a
different order.  With bf16 state, m'/v'/p' may round to a neighbouring bf16
value when the f32 results differ in their last bits: atol 1e-6 plus rtol
2^-7 (one bf16 ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import hostile_params, tol_for
from repro.configs import get_smoke as j_get_smoke
from repro.core.layout import ParamLayout as JLayout
from repro.kernels import flat_stats as jfs
from repro.kernels import flat_update as jfu
from repro.models import transformer as jt
from repro_torch.configs import get_smoke
from repro_torch.core.layout import FlatParams, ParamLayout, tree_paths
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu
from repro_torch.train.checkpoint import flat_from_numpy, flat_to_numpy, params_from_numpy

TOL = tol_for(jnp.float32)
BF16_STATE = dict(atol=1e-6, rtol=2.0**-7)
ARCHS = ["bert-large", "internlm2-1.8b"]


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


@pytest.fixture(scope="module")
def smoke_params():
    """{arch: reference init params (stacked, numpy)}."""
    return {a: jax.device_get(jt.init_params(j_get_smoke(a).model, jax.random.PRNGKey(0)))
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_geometry_matches_reference(arch, smoke_params):
    tree = smoke_params[arch]
    jl = JLayout.for_tree(tree)
    tl = ParamLayout.for_tree(tree)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(tl.paths) == jpaths
    assert tl.shapes == jl.shapes
    assert (tl.n_rows, tl.n_blocks, tl.leaf_slots) == (jl.n_rows, jl.n_blocks, jl.leaf_slots)
    assert tl.row_offsets == jl.row_offsets
    np.testing.assert_array_equal(tl.block_leaf_ids(), jl.block_leaf_ids())
    np.testing.assert_array_equal(tl.row_leaf_ids(), jl.row_leaf_ids())
    np.testing.assert_array_equal(tl.leaf_inv_sizes(), jl.leaf_inv_sizes())
    # the groups of the reference's scanned tree are stacked leaves
    assert any(p.startswith("groups/pos0/") and s[0] == j_get_smoke(arch).model.n_groups()
               for p, s in zip(tl.paths, tl.shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_matches_reference_row_for_row(arch, smoke_params):
    tree = smoke_params[arch]
    want = np.asarray(JLayout.for_tree(tree).pack(tree))
    got = flat_from_numpy(tree)
    np.testing.assert_array_equal(got.numpy(), want)
    # FlatParams packs the port's per-group tree into the same rows, and its
    # leaves are views of them
    cfg = get_smoke(arch)
    flat = FlatParams(params_from_numpy(tree, cfg.model), cfg.model.n_groups())
    np.testing.assert_array_equal(flat.data.numpy(), want)
    back = flat_to_numpy(flat.data, flat.layout)
    for (path, a), (_, b) in zip(tree_paths(back), tree_paths(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32), err_msg=path)
    wq = flat.tree["groups"][1]["pos0"]["attn"]["wq"]
    assert wq.requires_grad and wq.grad is not None
    assert wq.untyped_storage().data_ptr() == flat.data.untyped_storage().data_ptr()
    with torch.no_grad():
        flat.data.add_(1.0)
    np.testing.assert_array_equal(wq.detach().numpy(),
                                  np.asarray(tree["groups"]["pos0"]["attn"]["wq"][1]) + 1.0)


def test_flat_params_backward_writes_the_flat_grad():
    """Autograd accumulates each leaf's gradient in place into its rows of
    the flat gradient buffer; the padded tail stays zero."""
    rs = np.random.default_rng(0)

    def t_(*shape):
        return torch.from_numpy(rs.standard_normal(shape, dtype=np.float32))

    tree = {"embed": {"embed": t_(5, 3)}, "groups": [{"pos0": {"w": t_(3, 3)}} for _ in range(2)],
            "tail": []}
    flat = FlatParams(tree, 2)
    x = torch.from_numpy(rs.standard_normal((4, 3), dtype=np.float32))
    t = flat.tree
    loss = ((x @ t["groups"][0]["pos0"]["w"]) @ t["groups"][1]["pos0"]["w"]).sum() \
        + t["embed"]["embed"][[0, 2, 2]].sum()
    loss.backward()
    w0, w1 = (t["groups"][i]["pos0"]["w"].detach().clone().requires_grad_(True) for i in (0, 1))
    e = t["embed"]["embed"].detach().clone().requires_grad_(True)
    ((x @ w0) @ w1).sum().add(e[[0, 2, 2]].sum()).backward()
    stacked = flat.stacked("grad")
    np.testing.assert_allclose(stacked["groups"]["pos0"]["w"][0].numpy(), w0.grad.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(stacked["groups"]["pos0"]["w"][1].numpy(), w1.grad.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(stacked["embed"]["embed"].numpy(), e.grad.numpy(), rtol=1e-6)
    mask = torch.zeros_like(flat.grad, dtype=torch.bool)
    for v in flat.layout.leaf_views(mask):
        v.fill_(True)
    assert float(flat.grad[~mask].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K3 / K4 / K5 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _hostile_flat(seed):
    tree = jax.device_get(hostile_params(seed))
    layout = JLayout.for_tree(tree)
    return tree, layout, np.asarray(layout.pack(tree))


def test_moments_accum_and_finalize_match_reference():
    tree, jl, g0 = _hostile_flat(0)
    tl = ParamLayout.for_tree(tree)
    assert tl.n_rows == jl.n_rows
    k = 3
    gs_j = jnp.zeros_like(g0)
    g2s_j = jnp.zeros_like(g0)
    gs_t = torch.zeros(g0.shape)
    g2s_t = torch.zeros(g0.shape)
    for i in range(k):
        g = np.asarray(jl.pack(jax.device_get(hostile_params(i))))
        gs_j, g2s_j = jfs.flat_moments_accum(gs_j, g2s_j, jnp.asarray(g), jl, interpret=True)
        out = fs.flat_moments_accum(gs_t, g2s_t, torch.from_numpy(g.copy()))
        assert out[0] is gs_t and out[1] is g2s_t  # in place
        np.testing.assert_array_equal(gs_t.numpy(), np.asarray(gs_j))
        np.testing.assert_allclose(g2s_t.numpy(), np.asarray(g2s_j), rtol=1e-6, atol=0)
    mean_j, sq_j = jfs.flat_moments_finalize(gs_j, g2s_j, k, jl, interpret=True)
    mean_t, sq_t = fs.flat_moments_finalize(gs_t, g2s_t, k)
    np.testing.assert_array_equal(mean_t.numpy(), np.asarray(mean_j))
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-6, atol=0)
    # the zero tail stays zero
    pad = np.ones(g0.shape, bool)
    for off, size in zip(tl.row_offsets, tl.sizes):
        pad.reshape(-1)[off * 128: off * 128 + size] = False
    assert not mean_t.numpy()[pad].any() and not sq_t.numpy()[pad].any()


def _lamb_inputs(seed, layout):
    """Flat (g, ga, g2, m, v, p, w) with the zero tail the layout keeps."""
    rs = np.random.default_rng(seed)
    mask = np.zeros((layout.n_rows, 128), bool)
    for off, size in zip(layout.row_offsets, layout.sizes):
        mask.reshape(-1)[off * 128: off * 128 + size] = True

    def f(x):
        return np.where(mask, x, 0.0).astype(np.float32)

    shape = mask.shape
    g = f(rs.standard_normal(shape) * 0.1)
    g2 = f(g * g + rs.exponential(0.01, shape))
    ga = f(g * 0.7)
    m = f(rs.standard_normal(shape) * 0.01)
    v = f(rs.exponential(1e-3, shape))
    p = f(rs.uniform(0.1, 1.0, shape))
    w = f(rs.standard_normal(shape) * 0.5)
    return g, ga, g2, m, v, p, w


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.1, 1.0])
def test_flat_vr_lamb_matches_reference(state_dtype, gamma):
    tree, jl, _ = _hostile_flat(0)
    tl = ParamLayout.for_tree(tree)
    g, ga, g2, m, v, p, w = _lamb_inputs(1, tl)
    sd_j = jnp.dtype(state_dtype)
    sd_t = getattr(torch, state_dtype)
    m, v, p = (np.asarray(jnp.asarray(x).astype(sd_j).astype(jnp.float32)) for x in (m, v, p))
    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=gamma, gsnr_eps=1e-12)
    scal = (3e-3, 0.19, 0.001999, 0.19)
    want = jfu.flat_vr_lamb(
        *(jnp.asarray(x) for x in (g, ga, g2)), *(jnp.asarray(x).astype(sd_j) for x in (m, v, p)),
        jnp.asarray(w), jfu._scal8(*scal), jl, state_dtype=state_dtype, interpret=True, **hyper,
    )
    tm, tv, tp = (torch.from_numpy(x.copy()).to(sd_t) for x in (m, v, p))
    got = fu.flat_vr_lamb(*(torch.from_numpy(x) for x in (g, ga, g2)), tm, tv, tp,
                          torch.from_numpy(w), scal, tl, state_dtype=state_dtype, **hyper)
    assert got[1] is tm and got[2] is tv and got[3] is tp  # in place
    assert got[0].dtype == torch.float32 and tm.dtype == sd_t
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **TOL)
    tol = TOL if state_dtype == "float32" else BF16_STATE
    for name, a, b in zip("mvp", got[1:], want[1:]):
        np.testing.assert_allclose(a.float().numpy(), _np(b), err_msg=name, **tol)
    assert float(got[0].abs().max()) > 0


def test_flat_vr_lamb_zero_tail_and_gamma_one():
    """gamma = 1 collapses r to exactly 1 (p' = b3 p + 1 - b3).  The padded
    tail stays zero in upd, m' and v' (ga = w = 0 there); p' follows the
    reference there too: r is clipped up to gamma, so p' = (1 - b3) gamma."""
    tree, _, _ = _hostile_flat(2)
    tl = ParamLayout.for_tree(tree)
    g, ga, g2, m, v, p, w = (torch.from_numpy(x) for x in _lamb_inputs(3, tl))
    p0 = p.clone()
    upd, m2, v2, p2 = fu.flat_vr_lamb(g, ga, g2, m, v, p, w, (1e-3, 0.1, 0.001, 0.1), tl,
                                      b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=1.0,
                                      gsnr_eps=1e-12)
    mask = torch.zeros_like(g, dtype=torch.bool)
    for view in tl.leaf_views(mask):
        view.fill_(True)
    torch.testing.assert_close(p2[mask], (0.9 * p0 + 0.1)[mask])
    for t in (upd, m2, v2):
        assert float(t[~mask].abs().max()) == 0.0
    torch.testing.assert_close(p2[~mask], torch.full_like(p2[~mask], 0.1))


def test_flat_state_round_trip_from_reference_optimizer_state(smoke_params):
    """The reference's stacked m/v/p tree packs into the port's layout and
    back unchanged (the carry the train-step tests compare through)."""
    tree = smoke_params["bert-large"]
    rs = np.random.default_rng(4)
    state = jax.tree_util.tree_map(
        lambda x: rs.standard_normal(np.shape(x)).astype(np.float32), tree)
    layout = ParamLayout.for_tree(tree)
    buf = flat_from_numpy(state, layout, dtype=torch.bfloat16)
    back = flat_to_numpy(buf, layout)
    for (path, a), (_, b) in zip(tree_paths(back), tree_paths(state)):
        want = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(a, want, err_msg=path)


def test_layout_rejects_a_tree_of_another_structure(smoke_params):
    tree = smoke_params["bert-large"]
    layout = ParamLayout.for_tree(tree)
    other = dataclasses.replace(layout)  # geometry equality
    assert other == layout
    bad = dict(tree)
    bad.pop("head")
    with pytest.raises(ValueError, match="structure"):
        layout.pack(bad)
