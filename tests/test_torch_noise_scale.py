"""Port parity of the gradient-noise-scale readings (repro_torch.core.
noise_scale, the trainer's ``noise_scale=True`` step and the data-parallel
``with_noise_terms``) against the JAX package's.

Tolerances.  The readings are sums of squares over a whole carry, so they
are held to the exact value of the SAME carry: g2_small and g2_big within
rtol 1e-5 of an f64 sum (the per-leaf decomposition likewise, leaf by
leaf).  tr_sigma and g2 are differences of those two f32 sums, which are
close to each other, so summation order alone moves them (the reference's
own rtol-1e-6 packing-order test fails on it): each is held within an
absolute 1e-5 (g2_small + g2_big) times its largest coefficient, 1 / (1/B_s
- 1/B_b) for tr_sigma and B_b / (B_b - B_s) for g2; b_simple = tr_sigma / g2
then within the bound those two give.  Port and reference compute their
carries in different programs (their gradients agree to ~1e-6 relative),
so between packages the two sums get rtol 1e-4, and tr_sigma, g2 and
b_simple the bounds above with 1e-4 in place of 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise_scale as jns
from repro.core.gsnr import GradStats as JGradStats
from repro.core.layout import as_flat
from repro_torch.core import noise_scale as ns
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, ParamLayout, tree_leaves
from repro_torch.launch.mesh import make_host_mesh, run_ranks

SUM_RTOL = 1e-5
X_RTOL = 1e-4  # between packages: different carries
SHAPES = {"a": (517,), "b": (3,), "c": (64, 129), "d": (3, 5, 7)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized work: one intra-op thread keeps this file from
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(seed=0, scale=0.1):
    """A numpy carry (mean, sq_mean) with a valid variance: E[g^2] >= E[g]^2."""
    rng = np.random.default_rng(seed)
    mean = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    sq = {k: (m * m + rng.random(m.shape) * scale ** 2).astype(np.float32)
          for k, m in mean.items()}
    return mean, sq


def _f64_terms(mean, sq):
    leaf = np.array([[np.sum(np.square(mean[k].astype(np.float64))),
                      np.sum(sq[k].astype(np.float64))] for k in sorted(mean)])
    return leaf, leaf[:, 1].sum(), leaf[:, 0].sum()


def bounds(g2_small, g2_big, b_small, b_big, rtol):
    """Absolute bounds of tr_sigma and g2 (see the module note)."""
    scale = rtol * (abs(g2_small) + abs(g2_big))
    return scale / (1.0 / b_small - 1.0 / b_big), scale * b_big / (b_big - b_small)


def check_estimate(got, want, b_small, b_big, rtol, what=""):
    """``got`` (port readings, floats) against ``want`` (floats) at ``rtol``
    for the sums and the derived bounds for the rest."""
    for key in ("g2_small", "g2_big"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=f"{what} {key}")
    b_tr, b_g2 = bounds(want["g2_small"], want["g2_big"], b_small, b_big, rtol)
    assert abs(got["tr_sigma"] - want["tr_sigma"]) <= b_tr, (what, got, want, b_tr)
    assert abs(got["g2"] - want["g2"]) <= b_g2, (what, got, want, b_g2)
    b_b = (b_tr + abs(want["b_simple"]) * b_g2) / (abs(want["g2"]) - b_g2)
    assert abs(got["b_simple"] - want["b_simple"]) <= b_b, (what, got, want, b_b)


def _floats(est) -> dict:
    return {k: float(getattr(est, k)) for k in ("g2_small", "g2_big", "tr_sigma", "g2",
                                                "b_simple")}


@pytest.mark.parametrize("per_leaf", [False, True])
@pytest.mark.parametrize("form", ["flat", "tree"])
def test_noise_terms_and_estimate_match_the_reference(form, per_leaf):
    mean, sq = _carry()
    leaf64, g2s64, g2b64 = _f64_terms(mean, sq)
    tmean = {k: torch.from_numpy(v) for k, v in mean.items()}
    tsq = {k: torch.from_numpy(v) for k, v in sq.items()}
    if form == "flat":
        layout = ParamLayout.for_tree(tmean)
        stats = GradStats(FlatBuffer(layout.pack(tmean), layout),
                          FlatBuffer(layout.pack(tsq), layout), 4)
        jm = as_flat({k: jnp.asarray(v) for k, v in mean.items()})
        jstats = JGradStats(jm, as_flat({k: jnp.asarray(v) for k, v in sq.items()},
                                        layout=jm.layout), 4)
    else:
        stats = GradStats(tmean, tsq, 4)
        jstats = JGradStats({k: jnp.asarray(v) for k, v in mean.items()},
                            {k: jnp.asarray(v) for k, v in sq.items()}, 4)
    t = ns.noise_terms(stats, per_leaf=per_leaf)
    j = jns.noise_terms(jstats, per_leaf=per_leaf)
    np.testing.assert_allclose(float(t.g2_small), g2s64, rtol=SUM_RTOL)
    np.testing.assert_allclose(float(t.g2_big), g2b64, rtol=SUM_RTOL)
    if per_leaf:
        assert tuple(t.per_leaf.shape) == (len(SHAPES), 2)
        np.testing.assert_allclose(t.per_leaf.double().numpy(), leaf64, rtol=SUM_RTOL)
        np.testing.assert_allclose(t.per_leaf.numpy(), np.asarray(j.per_leaf), rtol=SUM_RTOL)
    else:
        assert t.per_leaf is None and j.per_leaf is None
    for b_small, b_big in ((4, 16), (2, 4), (63, 64)):
        want = _floats(jns.estimate_from_terms(jnp.float32(g2s64), jnp.float32(g2b64),
                                               b_small, b_big))
        got = _floats(ns.estimate(stats, b_small=b_small, b_big=b_big))
        check_estimate(got, want, b_small, b_big, SUM_RTOL, f"{form} {b_small}/{b_big}")
        assert got["b_simple"] == pytest.approx(got["tr_sigma"] / got["g2"], rel=1e-6)


def test_estimator_edges_and_validation():
    est = ns.estimate_from_terms(torch.tensor(2.0), torch.tensor(0.5), 4, 8)
    jest = jns.estimate_from_terms(jnp.float32(2.0), jnp.float32(0.5), 4, 8)
    assert _floats(est) == _floats(jest)
    # |G|^2 estimate exactly 0: b_simple is inf in both
    zero = ns.estimate_from_terms(torch.tensor(1.0), torch.tensor(0.5), 4, 8)
    assert float(zero.g2) == 0.0 and float(zero.b_simple) == float("inf")
    assert float(jns.estimate_from_terms(1.0, 0.5, 4, 8).b_simple) == float("inf")
    with pytest.raises(ValueError, match="sq_mean"):
        ns.noise_terms(GradStats({"w": torch.ones(4)}, None, 4))
    with pytest.raises(ValueError, match="b_big > b_small"):
        ns.estimate_from_terms(1.0, 1.0, b_small=8, b_big=8)


def test_ema_and_smoothing_match_the_reference():
    beta, values = 0.9, [3.0, -1.0, 4.0, 1.5, 9.2, 2.6]
    ours = theirs = None
    for i, y in enumerate(values):
        ours, ours_hat = ns.ema(ours, beta, y, i)
        theirs, theirs_hat = jns.ema(theirs, beta, y, i)
        assert (ours, ours_hat) == (theirs, theirs_hat)
    st, jst = ns.init_noise_state(), jns.init_noise_state()
    for tr, g2 in [(8.0, 2.0), (12.0, 3.0), (6.0, 1.0), (1.0, -4.0), (float("nan"), 1.0)]:
        st, sm = ns.update_noise_state(st, tr, g2, beta=0.8)
        jst, jsm = jns.update_noise_state(jst, tr, g2, beta=0.8)
        np.testing.assert_array_equal(np.asarray(st, np.float64), np.asarray(jst, np.float64))
        np.testing.assert_array_equal(np.asarray(sm), np.asarray(jsm))
    assert st.count == 5


# ---------------------------------------------------------------------------
# the trainer's readings on the bert-large smoke
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_train_step_readings_match_the_reference(plan):
    from repro.train import trainer as jtr
    from repro.models import transformer as jt
    from repro_torch.core.accumulate import grad_stats
    from repro_torch.data import lm_batches
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn
    from test_torch_train import _cfgs

    jcfg, tcfg = _cfgs("bert-large", plan, base_batch=4, lr_scale_rule="sqrt")
    jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
    batch = next(lm_batches(tcfg.model.vocab_size, tcfg.global_batch, tcfg.seq_len))
    jstate = jtr.init_state(jcfg, params=jp)
    _, jm = jax.jit(jtr.make_train_step(jcfg, noise_scale=True)[0])(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_state(tcfg, params=params_from_numpy(jax.device_get(jp), tcfg.model),
                       device="cpu")
    k, b_big = tcfg.optimizer.k, tcfg.global_batch
    # the step's own carry, taken from the same params first
    _, _, carry = grad_stats(make_loss_fn(tcfg), state.params,
                             {n: torch.from_numpy(v) for n, v in batch.items()}, k,
                             backend=tcfg.parallel.backend)
    mean = [x.double() for x in tree_leaves(carry.mean)]
    sq = [x.double() for x in tree_leaves(carry.sq_mean)]
    exact = {"g2_small": float(sum(x.sum() for x in sq)),
             "g2_big": float(sum((x * x).sum() for x in mean))}
    est = ns.estimate_from_terms(torch.tensor(exact["g2_small"], dtype=torch.float64),
                                 torch.tensor(exact["g2_big"], dtype=torch.float64),
                                 b_big / k, b_big)
    _, tm = make_train_step(tcfg, noise_scale=True, device="cpu")[0](state, batch)
    got = {key: float(tm[f"noise/{key}"]) for key in ("g2_small", "g2_big", "tr_sigma", "g2",
                                                      "b_simple")}
    check_estimate(got, _floats(est), b_big / k, b_big, SUM_RTOL, f"{plan}: own carry in f64")
    want = {key: float(jm[f"noise/{key}"]) for key in got}
    check_estimate(got, want, b_big / k, b_big, X_RTOL, f"{plan}: against the reference")
    assert got["b_simple"] > 0
    # the LR at step 0 on the sqrt rule at the live effective batch
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    # a stale step reads no noise terms but still reports the LR
    scfg = tcfg.replace(optimizer=dataclasses.replace(tcfg.optimizer, gsnr_refresh=2))
    stale = init_state(scfg, params=params_from_numpy(jax.device_get(jp), tcfg.model),
                       device="cpu")
    _, sm = make_train_step(scfg, noise_scale=True, device="cpu")[0](stale, batch, False)
    assert "lr" in sm and not any(key.startswith("noise/") for key in sm)


# ---------------------------------------------------------------------------
# the data-parallel readings (with_noise_terms) at W = 4
# ---------------------------------------------------------------------------


def _linreg_data():
    rs = np.random.default_rng(0)
    x = rs.standard_normal((64, 10)).astype(np.float32)
    y = x @ np.arange(1.0, 11.0, dtype=np.float32) + rs.standard_normal(64).astype(np.float32)
    return x, y


def _terms_rank(rank, world, init, out):
    from repro_torch.backend import Backend
    from repro_torch.core.distributed import device_grad_stats_fn
    from repro_torch.core.layout import FlatParams

    torch.set_num_threads(1)
    mesh = make_host_mesh(world, rank, init)
    x, y = _linreg_data()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def loss_fn(tree, b):
        return torch.mean((b["x"] @ tree["w"] + tree["b"] - b["y"]) ** 2), {}

    res = {}
    for plan, bk in (("flat", Backend.all_fused()), ("tree", Backend.all_reference())):
        for fused in (True, False):
            params = FlatParams({"w": torch.full((10,), 0.3), "b": torch.zeros(())}, 1,
                                device="cpu")
            fn = device_grad_stats_fn(loss_fn, mesh, fused=fused, backend=bk,
                                      with_noise_terms=True)
            _, _, stats, terms = fn(params, batch)
            res[plan, fused] = (terms.numpy().copy(), stats.k)
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def test_data_axis_noise_terms_match_the_reference_at_w4(tmp_path):
    from repro.core import grad_stats as j_grad_stats

    world = 4
    run_ranks(_terms_rank, world, args=(world, f"file://{tmp_path}/rdzv", str(tmp_path)),
              deadline_s=180.0)
    x, y = _linreg_data()

    def loss_fn(p, b):
        xb, yb = b
        return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    _, _, js = j_grad_stats(loss_fn, {"w": jnp.ones(10) * 0.3, "b": jnp.zeros(())},
                            (jnp.asarray(x), jnp.asarray(y)), world)
    jt = jns.noise_terms(js)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
    assert len(ranks[0]) == 4
    for key, (terms, k) in ranks[0].items():
        assert k == world and terms.shape == (2,) and terms.dtype == np.float32
        # [|G_big|^2, |G_small|^2], as the reference's payload terms
        np.testing.assert_allclose(terms, [float(jt.g2_big), float(jt.g2_small)], rtol=X_RTOL,
                                   err_msg=str(key))
        for other in ranks[1:]:  # every rank reads the same sums
            assert np.array_equal(other[key][0], terms), key
