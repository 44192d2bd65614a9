"""Port parity: the optimizer family (repro_torch.core.vrgd, core/baselines.py)
and the flat kernels' plain versions of VR-Adam (K6), VR-LARS (K7), the VR
scale (K8) and the g-only carry (K9) against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs its Pallas kernels in interpret mode (as tests/test_oracle.py
does) and its transforms on the reference plan (jnp tree math); the port's
kernel wrappers, given CPU tensors, compute their plain versions.  Each JAX
run is cached in a module-scoped fixture.

Tolerances:
  * kernels: ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4; the
    per-leaf sums run in another order), bf16 state one bf16 ulp
    (``BF16_STATE``: atol 1e-6, rtol 2^-7), the g-only carry exact (the same
    f32 additions); the padded tail is compared row for row, exactly.
  * transforms, two steps on the bert-large smoke params: updates and state
    rtol 2e-5 with atol 1e-6 of the largest magnitude compared (``_close``).
    Measured: every difference within 0.72 of that bound (the worst is
    VR-Adam's second update, whose direction m/sqrt(v) divides two moments
    that each differ by ~1e-6 of their scale: the GSNR ratio's per-leaf
    mean is summed in another order, and the learning rate and bias
    corrections are float32 numbers computed on the host).
  * gamma = 1: the reference's own test bound (rtol 1e-5, atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import hostile_params, tol_for
from repro.backend import Backend as JBackend
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import GradStats as JGradStats
from repro.core import make_optimizer as j_make_optimizer
from repro.core import vrgd as jvrgd
from repro.core.layout import FlatBuffer as JFlatBuffer
from repro.core.layout import ParamLayout as JLayout
from repro.kernels import flat_stats as jfs
from repro.kernels import flat_update as jfu
from repro.kernels import ops as jops
from repro.models import transformer as jt
from repro_torch.backend import Backend
from repro_torch.configs import OptimizerConfig
from repro_torch.core import vrgd
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, FlatParams, ParamLayout, is_flat, pad_mask, \
    tree_map, tree_paths
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu
from repro_torch.kernels import ops
from repro_torch.train.checkpoint import flat_from_numpy, flat_to_numpy, params_from_numpy

TOL = tol_for(jnp.float32)
BF16_STATE = dict(atol=1e-6, rtol=2.0**-7)
LAYOUTS = ["hostile", "bert-large", "internlm2-1.8b"]
VR = ["vr_sgd", "vr_momentum", "vr_adam", "vr_lars", "vr_lamb"]
BASE = ["sgd", "momentum", "adam", "lars", "lamb"]


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _tree(name):
    if name == "hostile":
        return jax.device_get(hostile_params(0))
    return jax.device_get(jt.init_params(j_get_smoke(name).model, jax.random.PRNGKey(0)))


def _flat_inputs(layout, seed):
    """Flat (g, ga, g2, m, v, p, w) with the zero tail the layout keeps."""
    rs = np.random.default_rng(seed)
    mask = pad_mask(layout).numpy()

    def f(x):
        return np.where(mask, x, 0.0).astype(np.float32)

    shape = mask.shape
    g = f(rs.standard_normal(shape) * 0.1)
    g2 = f(g * g + rs.exponential(0.01, shape))
    return dict(g=g, ga=f(g * 0.7), g2=g2, m=f(rs.standard_normal(shape) * 0.01),
                v=f(rs.exponential(1e-3, shape)), p=f(rs.uniform(0.1, 1.0, shape)),
                w=f(rs.standard_normal(shape) * 0.5), mask=mask)


ADAM_HYPER = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-8, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
ADAM_SCAL = (3e-3, 0.19, 0.001999, 0.19)
LARS_HYPER = dict(mu=0.9, wd=1e-4, trust=0.001, eps=1e-12)
LARS_SCAL = (0.05, 0.1)


@pytest.fixture(scope="module")
def flat_cases():
    """{layout name: (port layout, inputs, {kernel: JAX outputs})}; the JAX
    kernels run once per layout, in interpret mode."""
    out = {}
    for name in LAYOUTS:
        tree = _tree(name)
        jl = JLayout.for_tree(tree)
        tl = ParamLayout.for_tree(tree)
        x = _flat_inputs(tl, 1)
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "mask"}
        want = {"scale": jfu.flat_vr_scale(j["g"], j["ga"], j["g2"], jl, gamma=0.1, eps=1e-12,
                                           interpret=True)}
        for sd in ("float32", "bfloat16"):
            mvp = [j[k].astype(sd) for k in "mvp"]
            want[f"adam-{sd}"] = jfu.flat_vr_adam(
                j["g"], j["ga"], j["g2"], *mvp, j["w"], jfu._scal8(*ADAM_SCAL), jl,
                state_dtype=sd, interpret=True, **ADAM_HYPER)
        want["lars"] = jfu.flat_vr_lars(j["g"], j["ga"], j["g2"], j["m"], j["w"],
                                        jfu._scal8(*LARS_SCAL), jl, interpret=True, **LARS_HYPER)
        want["g_accum"] = jfs.flat_g_accum(j["m"], j["g"], jl, interpret=True)
        out[name] = (tl, x, {k: tuple(_np(a) for a in v) if isinstance(v, tuple) else _np(v)
                             for k, v in want.items()})
    return out


def _assert_flat(name, got, want, mask, tol):
    """Allclose everywhere, and the padded tail equal row for row."""
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, err_msg=name, **tol)
    np.testing.assert_array_equal(got[~mask], want[~mask], err_msg=f"{name} (padded tail)")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_vr_scale_matches_reference(layout, flat_cases):
    tl, x, want = flat_cases[layout]
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "mask"}
    sg, r = fu.flat_vr_scale(t["g"], t["ga"], t["g2"], tl, gamma=0.1, eps=1e-12)
    _assert_flat("sg", sg, want["scale"][0], x["mask"], TOL)
    _assert_flat("r", r, want["scale"][1], x["mask"], TOL)
    # the tail: r is clipped up to gamma, the scaled gradient is zero
    assert (r.numpy()[~x["mask"]] == np.float32(0.1)).all() and not sg.numpy()[~x["mask"]].any()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_vr_adam_matches_reference(layout, state_dtype, flat_cases):
    tl, x, want = flat_cases[layout]
    sd = getattr(torch, state_dtype)
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items() if k != "mask"}
    m, v, p = (t[k].to(sd) for k in "mvp")
    got = fu.flat_vr_adam(t["g"], t["ga"], t["g2"], m, v, p, t["w"], ADAM_SCAL, tl,
                          state_dtype=state_dtype, **ADAM_HYPER)
    assert got[1] is m and got[2] is v and got[3] is p and m.dtype == sd  # in place
    want = want[f"adam-{state_dtype}"]
    _assert_flat("upd", got[0], want[0], x["mask"], TOL)
    for name, a, b in zip("mvp", got[1:], want[1:]):
        _assert_flat(name, a, b, x["mask"], TOL if state_dtype == "float32" else BF16_STATE)
    # the tail: p' = b3 p + (1 - b3) gamma with p = 0 there
    np.testing.assert_allclose(p.float().numpy()[~x["mask"]], np.float32(0.1 * 0.1), rtol=2**-7)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_vr_lars_matches_reference(layout, flat_cases):
    tl, x, want = flat_cases[layout]
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items() if k != "mask"}
    upd, m = fu.flat_vr_lars(t["g"], t["ga"], t["g2"], t["m"], t["w"], LARS_SCAL, tl,
                             **LARS_HYPER)
    assert m is t["m"]  # in place
    _assert_flat("upd", upd, want["lars"][0], x["mask"], TOL)
    _assert_flat("m", m, want["lars"][1], x["mask"], TOL)


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_g_accum_matches_reference(layout, g_dtype, flat_cases):
    tl, x, want = flat_cases[layout]
    gs = torch.from_numpy(x["m"].copy())
    if g_dtype == "float32":
        assert fs.flat_g_accum(gs, torch.from_numpy(x["g"])) is gs  # in place
        np.testing.assert_array_equal(gs.numpy(), want["g_accum"])
    else:  # a bf16 gradient is widened to f32 before the add, as the reference does
        g = torch.from_numpy(x["g"]).to(torch.bfloat16)
        jw = jfs.flat_g_accum(jnp.asarray(x["m"]),
                              jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
                              JLayout.for_tree(_tree(layout)), interpret=True)
        np.testing.assert_array_equal(fs.flat_g_accum(gs, g).numpy(), _np(jw))


# ---------------------------------------------------------------------------
# the ten transforms against the reference's, on the port's two plans
# ---------------------------------------------------------------------------


def _opt_cfg(cls, name, **kw):
    return cls(name=name, lr=0.01, schedule="constant", weight_decay=0.01, gamma=0.1, **kw)


def _stats_np(params, seed):
    """(grads to apply, mean, sq_mean) trees shaped like ``params``."""
    rs = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(
        lambda x: (rs.standard_normal(np.shape(x)) * 0.1).astype(np.float32), params)
    sq = jax.tree_util.tree_map(
        lambda a: (a * a + rs.exponential(0.01, a.shape)).astype(np.float32), g)
    return jax.tree_util.tree_map(lambda a: a * np.float32(0.7), g), g, sq


@pytest.fixture(scope="module")
def smoke():
    """bert-large smoke: reference params, two steps of stats, and every
    reference transform's (update, state) after each step."""
    params = _tree("bert-large")
    steps = [_stats_np(params, s) for s in (5, 6)]
    runs = {}
    for name in VR + BASE:
        opt = j_make_optimizer(_opt_cfg(JOptimizerConfig, name),
                               backend=JBackend.all_reference())
        state, hist = opt.init(params), []
        for ga, g, sq in steps:
            upd, state = opt.update(ga, state, params, stats=JGradStats(g, sq, 8))
            hist.append(jax.device_get((upd, state)))
        runs[name] = hist
    return params, steps, runs


def _close(got, want, what):
    """rtol 2e-5 with atol 1e-6 of the largest magnitude over the tree."""
    want_leaves = [np.asarray(b, np.float32) for _, b in tree_paths(want)]
    got_leaves = [np.asarray(a, np.float32) for _, a in tree_paths(got)]
    assert len(got_leaves) == len(want_leaves), what
    scale = max(float(np.abs(b).max()) for b in want_leaves)
    for (path, _), a, b in zip(tree_paths(want), got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6 * scale, err_msg=f"{what} {path}")


def _to_numpy(x, layout):
    if is_flat(x):
        return flat_to_numpy(x.data, layout)
    return tree_map(lambda t: t.float().numpy(), x)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("name", VR + BASE)
def test_transform_matches_reference(name, plan, smoke):
    params, steps, runs = smoke
    cfg = j_get_smoke("bert-large").model
    flat = FlatParams(params_from_numpy(params, cfg), cfg.n_groups())
    layout = flat.layout
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    opt = vrgd.make_optimizer(_opt_cfg(OptimizerConfig, name), backend=bk)
    state = opt.init(flat)
    flat_form = plan == "fused" and name.startswith("vr_")
    assert all(is_flat(state[k]) == flat_form for k in ("m", "v", "p") if k in state)
    w = FlatBuffer(flat.data, layout) if flat_form else flat.stacked()

    def form(tree):
        buf = flat_from_numpy(tree, layout)
        return FlatBuffer(buf, layout) if flat_form else layout.unpack(buf)

    for i, ((ga, g, sq), (want_upd, want_state)) in enumerate(zip(steps, runs[name])):
        upd, state = opt.update(form(ga), state, w, stats=GradStats(form(g), form(sq), 8))
        assert is_flat(upd) == flat_form
        _close(_to_numpy(upd, layout), want_upd, f"{name} upd @ {i}")
        assert state["step"] == int(want_state["step"]) == i + 1
        for key in set(want_state) - {"step"}:
            if key == "pt":
                assert state["pt"] == int(want_state["pt"])
                continue
            _close(_to_numpy(state[key], layout), want_state[key], f"{name} {key} @ {i}")


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("base,vr", list(zip(BASE, VR)))
def test_gamma_one_reduces_to_base(base, vr, plan):
    """gamma = 1 clips r to exactly 1: each VR optimizer (on the fused plan
    through its kernel wrapper) takes its base optimizer's steps."""
    rs = np.random.default_rng(0)
    tree = {"dense": {"w": torch.from_numpy(rs.standard_normal((8, 4), dtype=np.float32) * 0.1),
                      "b": torch.from_numpy(rs.standard_normal(4, dtype=np.float32) * 0.1)},
            "out": torch.from_numpy(rs.standard_normal((40, 2), dtype=np.float32) * 0.1)}
    g = tree_map(lambda x: torch.from_numpy(rs.standard_normal(x.shape, dtype=np.float32)) * 0.1,
                 tree)
    sq = tree_map(lambda a: a * a + torch.from_numpy(rs.standard_normal(a.shape,
                                                                         dtype=np.float32)) ** 2,
                  g)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    final = {}
    for name, gamma in ((base, 0.1), (vr, 1.0)):
        flat = FlatParams(tree, 1)
        opt = vrgd.make_optimizer(OptimizerConfig(name=name, lr=0.01, schedule="constant",
                                                  gamma=gamma, weight_decay=0.0), backend=bk)
        state = opt.init(flat)
        flat_form = plan == "fused" and name.startswith("vr_")
        pack = (lambda t: FlatBuffer(flat.layout.pack(t), flat.layout)) if flat_form else \
            (lambda t: t)
        w = FlatBuffer(flat.data, flat.layout) if flat_form else flat.stacked()
        for _ in range(3):
            upd, state = opt.update(pack(g), state, w, stats=GradStats(pack(g), pack(sq), 8))
            tree_map(lambda p, u: p.add_(u), w, upd)
        final[name] = flat.data.clone()
    np.testing.assert_allclose(final[vr].numpy(), final[base].numpy(), rtol=1e-5, atol=1e-6)
    assert not torch.equal(final[base], FlatParams(tree, 1).data)


# ---------------------------------------------------------------------------
# stale-GSNR steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_stale_vr_adam_dir_matches_reference(state_dtype):
    """stats=None: p is left as it is, pt does not advance and the bias
    correction of p̂ uses max(pt, 1); on flat buffers as on trees."""
    tree = _tree("hostile")
    layout = ParamLayout.for_tree(tree)
    jl = JLayout.for_tree(tree)
    x = _flat_inputs(layout, 2)
    hyper = (0.9, 0.999, 0.9, 1e-6, 0.1, 1e-12, state_dtype)
    for pt in (0, 3):
        sd = jnp.dtype(state_dtype)
        jstate = {"step": jnp.asarray(4, jnp.int32), "pt": jnp.asarray(pt, jnp.int32),
                  **{k: JFlatBuffer(jnp.asarray(x[k]).astype(sd), jl) for k in "mvp"}}
        jd, jnew = jvrgd._vr_adam_dir(JFlatBuffer(jnp.asarray(x["ga"]), jl), jstate, None,
                                      *hyper)
        tstate = {"step": 4, "pt": pt, **{k: FlatBuffer(torch.from_numpy(x[k]).to(
            getattr(torch, state_dtype)), layout) for k in "mvp"}}
        p_before = tstate["p"].data.clone()
        td, tnew = vrgd._vr_adam_dir(FlatBuffer(torch.from_numpy(x["ga"]), layout), tstate,
                                     None, *hyper)
        assert tnew["pt"] == int(jnew["pt"]) == pt and tnew["step"] == 5
        assert torch.equal(tnew["p"].data, p_before)
        np.testing.assert_allclose(td.data.numpy(), _np(jd.data), **TOL)
        tol = TOL if state_dtype == "float32" else BF16_STATE
        for k in "mv":
            np.testing.assert_allclose(tnew[k].data.float().numpy(), _np(jnew[k].data), **tol)


def test_lamb_trust_flat_matches_reference():
    tree = _tree("hostile")
    layout = ParamLayout.for_tree(tree)
    jl = JLayout.for_tree(tree)
    x = _flat_inputs(layout, 3)
    want = jops.lamb_trust_flat(JFlatBuffer(jnp.asarray(x["m"]), jl),
                                JFlatBuffer(jnp.asarray(x["w"]), jl), 3e-3, 0.01)
    got = ops.lamb_trust_flat(FlatBuffer(torch.from_numpy(x["m"]), layout),
                              FlatBuffer(torch.from_numpy(x["w"]), layout), 3e-3, 0.01)
    want = jax.device_get(want)
    for (path, a), (_, b) in zip(tree_paths(got.unpack()), tree_paths(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=path, **TOL)


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("name", ["vr_adam", "vr_lamb"])
def test_stale_update_matches_reference(name, plan, smoke):
    """A fresh step then a stale one (stats=None) against the reference
    transform; on the fused plan the stale step runs plain torch on the
    flat state and launches nothing."""
    params, steps, _ = smoke
    jopt = j_make_optimizer(_opt_cfg(JOptimizerConfig, name), backend=JBackend.all_reference())
    cfg = j_get_smoke("bert-large").model
    flat = FlatParams(params_from_numpy(params, cfg), cfg.n_groups())
    layout = flat.layout
    fused = plan == "fused"
    opt = vrgd.make_optimizer(_opt_cfg(OptimizerConfig, name),
                              backend=Backend.all_fused() if fused else Backend.all_reference())
    jstate, state = jopt.init(params), opt.init(flat)
    w = FlatBuffer(flat.data, layout) if fused else flat.stacked()

    def form(tree):
        buf = flat_from_numpy(tree, layout)
        return FlatBuffer(buf, layout) if fused else layout.unpack(buf)

    for i, (ga, g, sq) in enumerate(steps):
        fresh = i == 0
        jupd, jstate = jopt.update(ga, jstate, params, stats=JGradStats(g, sq, 8) if fresh
                                   else None)
        upd, state = opt.update(form(ga), state, w,
                                stats=GradStats(form(g), form(sq), 8) if fresh else None)
        _close(_to_numpy(upd, layout), jax.device_get(jupd), f"{name} upd @ {i}")
        assert state["pt"] == int(jstate["pt"]) == 1
        for key in "mvp":
            _close(_to_numpy(state[key], layout), jax.device_get(jstate[key]),
                   f"{name} {key} @ {i}")


def test_optimizers_that_need_stats_raise_without_them():
    flat = FlatParams({"w": torch.ones(3, 5)}, 1)
    g = flat.stacked()
    for name in ("vr_sgd", "vr_momentum", "vr_lars"):
        opt = vrgd.make_optimizer(_opt_cfg(OptimizerConfig, name),
                                  backend=Backend.all_reference())
        with pytest.raises(ValueError, match="require GradStats"):
            opt.update(g, opt.init(flat), g, stats=None)


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_vr_adam_without_params_skips_the_weight_decay(plan, smoke):
    """update(params=None): no wd * w term, on the tree math and through the
    flat wrapper alike (the reference's rule)."""
    params, steps, _ = smoke
    ga, g, sq = steps[0]
    cfg = j_get_smoke("bert-large").model
    layout = FlatParams(params_from_numpy(params, cfg), cfg.n_groups()).layout
    fused = plan == "fused"

    def form(tree):
        buf = flat_from_numpy(tree, layout)
        return FlatBuffer(buf, layout) if fused else layout.unpack(buf)

    bk = Backend.all_fused() if fused else Backend.all_reference()
    upds = []
    for wd in (0.01, 0.0):
        opt = vrgd.make_optimizer(OptimizerConfig(name="vr_adam", lr=0.01, schedule="constant",
                                                  weight_decay=wd, gamma=0.1), backend=bk)
        state = opt.init(FlatParams(params_from_numpy(params, cfg), cfg.n_groups()))
        upd, _ = opt.update(form(ga), state, None, stats=GradStats(form(g), form(sq), 8))
        upds.append(_to_numpy(upd, layout))
    for (path, a), (_, b) in zip(tree_paths(upds[0]), tree_paths(upds[1])):
        np.testing.assert_array_equal(a, b, err_msg=path)
