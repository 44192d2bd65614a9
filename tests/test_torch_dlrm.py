"""Port parity: DLRM (repro_torch.models.dlrm, configs/dlrm.py) and the
generic step loop (repro_torch.train.driver) against the JAX package and
``benchmarks/common.py``.

The parameters are the reference's ``init_params`` carried across with
``models/dlrm.py::params_from_numpy``; the batches are the numpy
``ctr_batches`` (the port's is a copy of the reference's).  The JAX side runs
its reference plan, or for the fused plan its Pallas kernels as its own
tests run them on the CPU (interpret mode); the port's kernel wrappers
compute their plain versions on CPU tensors.

Tolerances: ``oracle.tol_for(float32)`` (atol 2e-5, rtol 2e-4) on logits
and params, the same f32 math in another summation order (params measured
<= 3.0e-8 apart); losses rtol 1e-5 (measured <= 8.7e-8 relative); each
leaf's change over a VR-SGD step within STEP_REL = 1e-4 of the reference's
change relative to its norm (measured <= 5.1e-6 on both plans).  The GSNR
ratio of a table element seen by one of the k = 4 microbatches is 1/3 up
to rounding in both packages' math, and an element no microbatch saw has
r = 0 and a zero gradient, so the sparse tables add no ill-conditioning
beyond the MLPs'.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import tol_for
from repro.backend import Backend as JBackend
from repro.configs import dlrm as j_cfg
from repro.configs.base import OptimizerConfig as JOpt
from repro.core import grad_stats as j_grad_stats
from repro.core import make_optimizer as j_make_optimizer
from repro.core.layout import ParamLayout as JLayout
from repro.models import dlrm as jd
from repro_torch.backend import Backend
from repro_torch.configs import dlrm as t_cfg
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.layout import FlatParams, ParamLayout, tree_paths
from repro_torch.data import CTRModel, ctr_batches
from repro_torch.models import dlrm as td
from repro_torch.train.checkpoint import flat_to_numpy
from repro_torch.train.driver import auc, train_optimizer

sys.path.append(os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import common as bench  # noqa: E402  (the reference driver, read only)

TOL = tol_for(jnp.float32)
LOSS_RTOL = 1e-5
STEP_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized work: one intra-op thread keeps this file from
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed=0):
    """(the reference's init params as numpy, the same as the port's tree)."""
    jp = jax.device_get(jd.init_params(cfg, jax.random.PRNGKey(seed)))
    return jp, td.params_from_numpy(jp)


def _batches(cfg, batch, n, seed=0):
    stream = ctr_batches(batch, cfg.table_size, cfg.n_sparse_features, seed=seed)
    return [next(stream) for _ in range(n)]


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_tree_close(got, want, what, **tol):
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=f"{what} {path}", **tol)


def test_configs_match_the_reference():
    for name in ("config", "smoke"):
        assert vars(getattr(t_cfg, name)()) == vars(getattr(j_cfg, name)())
    opt, jopt = t_cfg.optimizer(), j_cfg.optimizer()
    assert (opt.name, opt.lr, opt.schedule, opt.gamma, opt.k, opt.warmup_steps) == \
        (jopt.name, jopt.lr, jopt.schedule, jopt.gamma, jopt.k, jopt.warmup_steps) == \
        ("vr_sgd", 2 ** 3.5, "poly", 0.1, 8, 100)


def test_forward_and_loss_match_jax():
    cfg = t_cfg.smoke()
    jp, tp = _params(cfg)
    (b,) = _batches(cfg, 32, 1)
    want = jd.forward(cfg, jp, jnp.asarray(b["dense"]), jnp.asarray(b["sparse"]))
    got = td.forward(cfg, tp, torch.from_numpy(b["dense"]), torch.from_numpy(b["sparse"]))
    assert got.shape == (32,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    t_loss = td.loss_fn(cfg)(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert t_loss[1] == {}
    np.testing.assert_allclose(float(t_loss[0]), float(jd.bce_loss(cfg, jp, _jbatch(b))),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("f", [2, 5, 27])
def test_interaction_pairs_follow_triu_indices(f):
    iu, ju = td.interaction_pairs(f)
    jiu, jju = jnp.triu_indices(f, k=1)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


@pytest.mark.parametrize("table_size", [None, 2 ** 19, 2 ** 20], ids=["smoke", "2^19", "2^20"])
def test_flat_layout_matches_the_reference(table_size):
    """Leaf paths, sizes and row offsets of the one-group FlatParams layout
    against the reference's ``ParamLayout.for_tree`` on the DLRM tree; the
    full widths are traced as shapes (no memory).  At 2^20 rows per table the
    tables leaf holds more than 2^31 elements: the host offsets are Python
    integers and stay exact."""
    cfg = t_cfg.smoke() if table_size is None else t_cfg.config()
    if table_size is not None:
        cfg = type(cfg)(**{**vars(cfg), "table_size": table_size})
    jshapes = jax.eval_shape(lambda k: jd.init_params(cfg, k), jax.random.PRNGKey(0))
    want = JLayout.for_tree(jshapes)
    meta = td.init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    got = ParamLayout.for_tree(meta)
    if table_size is None:  # the layout FlatParams builds of the real tree
        assert FlatParams(td.init_params(cfg, torch.Generator().manual_seed(0)), 1).layout == got
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    assert got.paths == tuple(jpaths)
    assert got.shapes == tuple(want.shapes)
    assert got.sizes == tuple(want.sizes)
    assert got.row_offsets == tuple(int(x) for x in want.row_offsets)
    assert got.n_rows == int(want.n_rows)
    tables = got.paths.index("tables")
    size = cfg.n_sparse_features * cfg.table_size * cfg.embedding_dim
    assert got.sizes[tables] == size
    if table_size is not None:  # D = 128: one flat row per embedding row, no padding
        assert got.leaf_rows[tables] == size // 128 == cfg.n_sparse_features * table_size
    if table_size == 2 ** 20:
        assert (got.row_offsets[tables] + got.leaf_rows[tables]) * 128 > 2 ** 31


def _jax_vr_sgd_steps(cfg, jp, batches, opt_cfg, plan):
    """The reference's VR-SGD loop (tests/test_dlrm.py's step) on ``plan``:
    params after each step and the losses."""
    bk = JBackend.all_fused() if plan == "fused" else JBackend.all_reference()
    opt = j_make_optimizer(JOpt(**opt_cfg), backend=bk)

    def loss_fn(p, b):
        return jd.bce_loss(cfg, p, b)

    @jax.jit
    def step(p, s, b):
        loss, _, stats = j_grad_stats(loss_fn, p, b, opt_cfg["k"], backend=bk)
        upd, s = opt.update(stats.mean, s, p, stats=stats)
        return jax.tree_util.tree_map(jnp.add, p, upd), s, loss

    state, out = opt.init(jp), []
    for b in batches:
        jp, state, loss = step(jp, state, _jbatch(b))
        out.append((jax.device_get(jp), float(loss)))
    return out


@pytest.mark.parametrize("plan", ["reference", "fused"])
def test_three_vr_sgd_steps_match_jax(plan):
    """Table 11's VR-SGD (poly schedule, warm-up 100, gamma 0.1) at k = 4:
    loss and params after each of three steps through the port's
    ``train_optimizer``, against the JAX loop on the same plan."""
    cfg = t_cfg.smoke()
    jp, tp = _params(cfg)
    batches = _batches(cfg, 64, 3)
    opt = t_cfg.optimizer()
    opt_kw = dict(name=opt.name, lr=opt.lr, schedule=opt.schedule, gamma=opt.gamma, k=4,
                  warmup_steps=opt.warmup_steps)
    want = _jax_vr_sgd_steps(cfg, jp, batches, opt_kw, plan)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    seen, before = [], [(jp, jp)]

    def check(i, flat, loss):
        seen.append(i)
        jparams, jloss = want[i]
        got = flat_to_numpy(flat.data.clone(), flat.layout)  # the next step updates in place
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL, err_msg=f"loss @ {i}")
        _assert_tree_close(got, jparams, f"params @ {i}", **TOL)
        t0, j0 = before[-1]
        for (path, a), (_, b), (_, a0), (_, b0) in zip(
                tree_paths(got), tree_paths(jparams), tree_paths(t0), tree_paths(j0)):
            step = np.asarray(b) - np.asarray(b0)
            gap = np.linalg.norm((a - np.asarray(a0)) - step)
            assert gap <= STEP_REL * np.linalg.norm(step), (path, i, gap)
        before.append((got, jparams))

    out = train_optimizer(td.loss_fn(cfg), tp, batches, OptimizerConfig(**opt_kw), 3,
                          backend=bk, device="cpu", callback=check)
    assert seen == [0, 1, 2] and len(out["losses"]) == 3


def test_bce_trains_with_vr_sgd():
    """tests/test_dlrm.py::test_bce_trains_with_vr_sgd on the port: 30 VR-SGD
    steps (k = 4, constant lr 0.05) lower the loss."""
    cfg = t_cfg.smoke()
    _, tp = _params(cfg)
    out = train_optimizer(td.loss_fn(cfg), tp, ctr_batches(64, cfg.table_size,
                                                           cfg.n_sparse_features, seed=0),
                          OptimizerConfig(name="vr_sgd", lr=0.05, schedule="constant", k=4),
                          30, device="cpu")
    assert out["losses"][-1] < out["losses"][0]
    assert out["final_loss"] == out["losses"][-1] and len(out["step_s"]) == 30


@pytest.mark.parametrize("name", ["sgd", "vr_sgd"])
def test_train_optimizer_matches_the_reference_driver(name):
    """train/driver.py::train_optimizer against benchmarks/common.py's on
    smoke(), five steps: the losses, steps_to_target, the eval and the final
    params."""
    cfg = t_cfg.smoke()
    jp, tp = _params(cfg)
    batches = _batches(cfg, 64, 5)
    kw = dict(name=name, lr=0.15, schedule="poly", warmup_steps=2, total_steps=5, k=4)
    model = CTRModel(table_size=cfg.table_size, n_sparse=cfg.n_sparse_features, seed=0)
    test = model.sample(256, np.random.RandomState(123))

    def j_eval(p):
        return bench.auc(test["label"], np.asarray(
            jd.forward(cfg, p, jnp.asarray(test["dense"]), jnp.asarray(test["sparse"]))))

    def t_eval(flat):
        with torch.no_grad():
            scores = td.forward(cfg, flat.tree, torch.from_numpy(test["dense"]),
                                torch.from_numpy(test["sparse"]))
        return auc(test["label"], scores.numpy())

    want = bench.train_optimizer(lambda p, b: jd.bce_loss(cfg, p, b), jp,
                                 (_jbatch(b) for b in batches), JOpt(**kw), 5, eval_fn=j_eval,
                                 target=0.69)
    got = train_optimizer(td.loss_fn(cfg), tp, iter(batches), OptimizerConfig(**kw), 5,
                          eval_fn=t_eval, target=0.69, device="cpu")
    assert set(got) == set(want) | {"step_s"}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["final_loss"] == got["losses"][-1]
    assert got["steps_to_target"] == want["steps_to_target"]
    np.testing.assert_allclose(got["eval"], want["eval"], atol=2 / 256 ** 2)
    flat = got["params"]
    _assert_tree_close(flat_to_numpy(flat.data, flat.layout), jax.device_get(want["params"]),
                       "final params", **TOL)


def test_auc_matches_the_reference():
    """The Mann-Whitney AUC with tied ranks averaged, on scores with many
    ties, against benchmarks/common.py::auc; a one-class input gives 0.5."""
    rng = np.random.RandomState(0)
    labels = (rng.rand(997) < 0.3).astype(np.float32)
    scores = np.round(rng.randn(997) + labels, 1)
    assert len(np.unique(scores)) < 100
    assert auc(labels, scores) == bench.auc(labels, scores)
    pos, neg = scores[labels > 0.5], scores[labels <= 0.5]
    pairs = (pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()
    np.testing.assert_allclose(auc(labels, scores), pairs / (pos.size * neg.size), rtol=1e-12)
    assert auc(np.ones(5), scores[:5]) == bench.auc(np.ones(5), scores[:5]) == 0.5
