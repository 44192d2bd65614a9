"""Port parity: plans whose stats and optimizer subsystems resolve
differently (the reference's ``tests/test_backend.py`` mixed-plan tests).

The flat GradStats of a fused stats plan feed a reference-plan optimizer
(unpacked on entry) and the tree GradStats of a reference stats plan feed a
fused optimizer (packed on entry, into the layout of the params).  Each port
run is held against the JAX package's all-reference numbers on the same
numpy inputs, at the reference test's tolerances (rtol 5e-5, atol 1e-7 on
the update; the loss rtol 1e-6); the trainer's mixed step against the
port's all-reference step at tests/test_torch_train.py's (loss, grad_norm
and update_norm rtol 1e-5, params ``oracle.tol_for(float32)``, m/v/p per
leaf within 3e-3 of their norm).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from repro.backend import Backend as JBackend
from repro.configs.base import OptimizerConfig as JOpt
from repro.core import grad_stats as j_grad_stats
from repro.core import make_optimizer as j_make_optimizer
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.accumulate import grad_stats
from repro_torch.core.layout import FlatParams, is_flat, tree_paths, unpack_tree
from repro_torch.core.vrgd import make_optimizer
from repro_torch.data import lm_batches
from repro_torch.train import init_state, make_train_step
from repro_torch.train.checkpoint import flat_to_numpy

MIXED = (Backend(optimizer="fused", stats="reference", attention="reference"),
         Backend(optimizer="reference", stats="fused", attention="reference"))
MIXED_IDS = ("fused-opt-tree-stats", "tree-opt-fused-stats")
UPD_TOL = dict(rtol=5e-5, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_setup():
    """tests/test_backend.py's quadratic problem with numpy inputs."""
    rng = np.random.RandomState(0)
    params = {"w": np.linspace(-1.0, 1.0, 500, dtype=np.float32), "b": np.ones((), np.float32)}
    x = (rng.randn(16, 500) * 0.3).astype(np.float32)
    y = np.tanh(x @ np.linspace(0.5, -0.5, 500, dtype=np.float32)).astype(np.float32)
    return params, {"x": x, "y": y}


def _j_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _t_loss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {}


def _reference_update(name, params, batch, **opt):
    """(loss, update) of one all-reference JAX step."""
    cfg = JOpt(name=name, schedule="constant", **opt)
    bk = JBackend.all_reference()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    loss, _, stats = j_grad_stats(_j_loss, jp, {k: jnp.asarray(v) for k, v in batch.items()}, 4,
                                  backend=bk)
    opt_ = j_make_optimizer(cfg, backend=bk)
    upd, _ = opt_.update(stats.mean, opt_.init(jp), jp, stats=stats)
    return float(loss), jax.device_get(upd)


def _port_update(name, plan, params, batch, **opt):
    """(loss, GradStats, update) of one port step on ``plan``; the params
    enter the optimizer as the stacked tree."""
    flat = FlatParams({k: torch.from_numpy(v.copy()) for k, v in params.items()}, 1,
                      device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, stats = grad_stats(_t_loss, flat, tb, 4, backend=plan)
    opt_ = make_optimizer(OptimizerConfig(name=name, schedule="constant", **opt), backend=plan)
    upd, _ = opt_.update(stats.mean, opt_.init(flat), flat.stacked(), stats=stats)
    return float(loss), stats, upd


def _assert_update_close(got, want, what):
    got = unpack_tree(got)
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{what} {path}", **UPD_TOL)


@pytest.mark.parametrize("plan", MIXED, ids=MIXED_IDS)
def test_mixed_plans_cross_the_flat_boundary(plan):
    """tests/test_backend.py::test_mixed_plans_cross_the_flat_boundary: flat
    GradStats feed the tree optimizer (unpacked on entry) and tree GradStats
    feed the fused optimizer (packed on entry); VR-Adam's update matches the
    all-reference JAX step, and leaves in the optimizer's form."""
    params, batch = _quad_setup()
    want_loss, want_upd = _reference_update("vr_adam", params, batch, lr=0.05)
    loss, stats, upd = _port_update("vr_adam", plan, params, batch, lr=0.05)
    assert is_flat(stats.mean) == (plan.stats == "fused")
    assert is_flat(upd) == (plan.optimizer == "fused")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    _assert_update_close(upd, want_upd, plan)


@pytest.mark.parametrize("name", ["vr_sgd", "vr_momentum", "vr_lamb"])
def test_fused_stats_flat_grads_survive_reference_momentum(name):
    """tests/test_backend.py::test_fused_stats_flat_grads_survive_reference_
    momentum: a FlatBuffer mean gradient from fused stats entering a
    reference-plan update is unpacked at the transform boundary; the update
    is a tree shaped as the params and equals the all-reference JAX one."""
    params, batch = _quad_setup()
    plan = MIXED[1]
    _, want_upd = _reference_update(name, params, batch, lr=0.01)
    _, stats, upd = _port_update(name, plan, params, batch, lr=0.01)
    assert is_flat(stats.mean) and not is_flat(upd)
    assert [p for p, _ in tree_paths(upd)] == [p for p, _ in tree_paths(want_upd)] == ["b", "w"]
    _assert_update_close(upd, want_upd, name)


def _bert_cfg(plan):
    cfg = get_smoke("bert-large")
    return cfg.replace(
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=plan))


def _flat_state(state, name):
    x = state.opt_state[name]
    if is_flat(x):
        return flat_to_numpy(x.data, x.layout)
    return {p: v.numpy() for p, v in tree_paths(x)}


@pytest.mark.parametrize("plan", MIXED, ids=MIXED_IDS)
def test_train_step_on_a_mixed_plan_matches_the_reference_plan(plan):
    """make_train_step at bert-large's smoke size (f32 compute, VR-LAMB, k =
    4): two steps on a mixed plan against two on the all-reference plan from
    the same params and batches; the optimizer state keeps the optimizer's
    form."""
    cfg = _bert_cfg(plan)
    stream = lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len)
    batches = [next(stream) for _ in range(2)]
    runs = {}
    for label, bk in (("mixed", plan), ("reference", Backend.all_reference())):
        c = _bert_cfg(bk)
        state = init_state(c, device="cpu")
        step = make_train_step(c, log_gsnr=True, device="cpu")[0]
        hist = []
        for b in batches:
            state, m = step(state, b)
            hist.append({k: float(v) for k, v in m.items()})
        runs[label] = (state, hist)
    (mixed, mh), (ref, rh) = runs["mixed"], runs["reference"]
    assert is_flat(mixed.opt_state["m"]) == (plan.optimizer == "fused")
    for a, b in zip(mh, rh):
        assert set(a) == set(b)
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
        for key in ("gsnr/mean", "gsnr/min", "gsnr/frac_floor"):
            np.testing.assert_allclose(a[key], b[key], atol=5e-4, err_msg=key)
    got = flat_to_numpy(mixed.params.data, mixed.params.layout)
    want = flat_to_numpy(ref.params.data, ref.params.layout)
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        np.testing.assert_allclose(a, b, err_msg=f"params {path}", **tol_for(jnp.float32))
    for name in "mvp":
        got, want = _flat_state(mixed, name), _flat_state(ref, name)
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want), strict=True):
            assert np.linalg.norm(a - b) <= 3e-3 * np.linalg.norm(b) + 1e-12, (name, path)


def test_a_mixed_plan_under_a_mesh_raises():
    """Under a mesh the carry and the update hold a rank's rows, which do not
    cross into the tree form: a mixed plan refuses there, with a message."""
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="runs on one device only"):
        make_train_step(_bert_cfg(MIXED[1]), device="cpu", mesh=mesh)
