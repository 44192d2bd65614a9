"""Port parity of the data-parallel training paths beside the data-axis
GSNR source: the microbatch source, stale steps, the vmap stats method and
the baselines under a mesh, over spawned gloo ranks on the CPU.

* One group of W = 2 ranks (``launch/mesh.py::start_ranks``, one torch
  thread each, a rendezvous file under ``tmp_path``) runs every case on the
  bert-large smoke in f32 compute, on both plans, from the reference's init
  params and the reference's batches: VR-LAMB at k = 4 with
  ``gsnr_refresh=2`` (fresh, stale, fresh), VR-LAMB at k = 2 (one fresh
  step), VR-Adam at k = 4 with ``gsnr_refresh=2`` (fresh, stale, fresh),
  VR-LAMB with ``stats_method="vmap"`` at k = 4 (fresh, stale), and one
  LAMB and one Adam step.  Each step is held against the JAX
  ``make_train_step`` on one device with the same k on the same batches
  (the reference's mesh path equals that step: tests/test_spmd_flat.py) at
  tests/test_torch_train.py's tolerances (``_compare``; the fused plan's
  row-sharded m/v/p gathered first).  The vmap run is held against the JAX
  scan step, which the reference's vmap method equals.  After every step
  the ranks' params must be bit-identical.

  VR-LAMB at k = 2 is held against the JAX step on the loss, grad_norm,
  update_norm and params only.  With two groups the GSNR r of an element is
  ((g0 + g1) / (g0 - g1))^2, whose leaf means are set by a few elements
  whose groups cancel, and one rounding of a group's gradient moves them
  (test_torch_distributed.py's docstring; its
  ``test_two_group_gsnr_moves_with_one_rounding_of_the_squares`` measures
  0.22 / 0.36 / 0.19 of a leaf for m / v / p).  Under a mesh each group's
  gradient is the sum of two ranks' half-group backwards, which rounds
  otherwise than one backward over the group, so the gsnr/* readings and
  the m, v, p state of a k = 2 step are not comparable across the two.
  The first Adam step moves by about lr x sign(g) whatever r is, so the
  params and the update norm are.  The whole of ``_compare`` holds the
  k = 2 mesh step against the port's one-card step whose loss takes each
  group in the ranks' two halves (``core/accumulate.py::rank_split_loss``),
  which rounds the gradient as the mesh does; rank 0 runs it.

* The loss's normaliser: a packed batch whose pad rows all fall on rank 1
  gives, through ``grad_stats`` under the mesh, the single-card loss and
  mean gradient (token and document norms); each rank's own mean,
  averaged, does not; and a loss function without a ``denominator``
  raises under the mesh.
* The readings under the mesh (``noise_scale=True``, ``log_gsnr=True``,
  from the carry's rows) against the port's single-card step, and against
  the single-card reductions of the ranks' carry gathered whole, rtol 1e-5.
* ``DataMesh.reduce_scatter_`` on the ranks.
* Without ranks: the per-shard K3, K9, K4 and K10 (``FlatSpmd``'s
  ``moments_accum``, ``g_accum``, ``moments_finalize``, ``vmap_moments``;
  their plain versions on the CPU) on the hostile layout (19 blocks) split
  over 2, 3 and 4 shards, which pads the last shard and splits a leaf across
  two: each shard's rows ``torch.equal`` to the whole-buffer op's rows.  And
  ``gsnr_source="data_axis"`` without a mesh is the microbatch step.

The rank function lives in this module and the ranks import it, so JAX is
imported inside the test functions only.
"""
import dataclasses
import pickle
import types

import numpy as np
import pytest
import torch

from repro_torch.backend import FlatSpmd
from repro_torch.core.layout import FlatBuffer, ParamLayout, RowShard, tree_leaves, tree_paths
from repro_torch.launch.mesh import make_host_mesh, start_ranks, wait_ranks
from repro_torch.sharding import Rules
from test_torch_distributed import _as_state, _snapshot

WORLD = 2
DEADLINE_S = 240.0
PLANS = ("fused", "reference")
# case -> (optimizer, OptimizerConfig overrides, fresh flag of each step)
RUNS = {
    "vr_lamb k4": ("vr_lamb", dict(k=4, gsnr_refresh=2), (True, False, True)),
    "vr_lamb k2": ("vr_lamb", dict(k=2), (True,)),
    "vr_adam": ("vr_adam", dict(k=4, gsnr_refresh=2), (True, False, True)),
    "vr_lamb vmap": ("vr_lamb", dict(k=4, gsnr_refresh=2, stats_method="vmap"), (True, False)),
    "lamb": ("lamb", dict(k=4), (True,)),
    "adam": ("adam", dict(k=4), (True,)),
}
# the JAX run each case is held against (the vmap method against the scan's)
JAX_RUN = {case: case for case in RUNS} | {"vr_lamb vmap": "vr_lamb k4"}
NOISE = ("g2_small", "g2_big", "tr_sigma", "g2", "b_simple")
GSNR = ("gsnr/mean", "gsnr/min", "gsnr/frac_floor")
READINGS = tuple(f"noise/{k}" for k in NOISE) + GSNR
LOSS_NORMS = ("token", "document")
# the k = 2 mesh step against the one-card step split as the ranks split:
# the sums of the leaves that straddle the two shards taken in another order
# (the first run measured update_norm 7.7e-8 apart, every other value equal)
SPLIT_RTOL = 1e-6


def _port_cfg(plan, name, loss_norm="token", **opt):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    cfg = get_smoke("bert-large")
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    return cfg.replace(
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=bk),
        optimizer=dataclasses.replace(cfg.optimizer, name=name, **opt), loss_norm=loss_norm)


def _packed_batch(cfg):
    """Two 4-row groups whose rows 2 and 3 (rank 1's) hold the pads: a
    whole pad row and a short document, against rank 0's full rows."""
    from oracle import packed_positions

    s = cfg.seq_len
    rows = [[(s // 2, 0), (s // 2, 0)], [(s, 0)], [(0, 0)], [(5, 0), (3, 0)]]
    pos = np.stack([packed_positions(s, rows[i % 4]) for i in range(cfg.global_batch)])
    toks = np.random.default_rng(7).integers(0, cfg.model.vocab_size,
                                             size=(cfg.global_batch, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "positions": pos}


def _whole(x, mesh):
    """A FlatBuffer's whole buffer (its rows gathered when it holds a
    shard), as a new tensor."""
    return (x.shard.gather(x.data, mesh) if x.shard is not None else x.data).clone()


def _normaliser_runs(mesh, jparams):
    """grad_stats under the mesh on the packed batch, k = 2, fused plan:
    {loss_norm: (loss, mean gradient, mean gradient of each rank's own
    mean, whether a loss without a ``denominator`` raised)}."""
    from repro_torch.core.accumulate import LOSS_DENOM, grad_stats
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn

    out = {}
    for norm in LOSS_NORMS:
        cfg = _port_cfg("fused", "vr_lamb", norm, k=2)
        state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu",
                           mesh=mesh)
        batch = {k: torch.as_tensor(v) for k, v in _packed_batch(cfg).items()}
        bk = cfg.parallel.backend
        loss_fn = make_loss_fn(cfg)
        loss, _, stats = grad_stats(loss_fn, state.params, batch, 2, backend=bk,
                                    spmd=bk.shard(mesh))
        mean = _whole(stats.mean, mesh)
        def own_mean(p, b):
            return loss_fn(p, {k: v for k, v in b.items() if k != LOSS_DENOM})

        own_mean.denominator = loss_fn.denominator
        own = grad_stats(own_mean, state.params, batch, 2, backend=bk, spmd=bk.shard(mesh))[2]
        try:
            grad_stats(lambda p, b: loss_fn(p, b), state.params, batch, 2, backend=bk,
                       spmd=bk.shard(mesh))
            raised = False
        except ValueError as e:
            raised = "denominator" in str(e)
        out[norm] = (float(loss), mean, _whole(own.mean, mesh), raised)
    return out


def _readings_run(mesh, jparams, batch):
    """One fused VR-LAMB k = 4 step with the readings, and the single-card
    reductions of the same step's carry gathered whole."""
    from repro_torch.core import noise_scale as ns
    from repro_torch.core.accumulate import grad_stats
    from repro_torch.core.gsnr import GradStats, gsnr_scale, gsnr_summary, gsnr_summary_rows
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn

    cfg = _port_cfg("fused", "vr_lamb", k=4)
    state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu",
                       mesh=mesh)
    bk = cfg.parallel.backend
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, _, stats = grad_stats(make_loss_fn(cfg), state.params, tb, 4, backend=bk,
                             spmd=bk.shard(mesh))
    b = cfg.global_batch
    rows = dict(gsnr_summary_rows(stats, cfg.optimizer.gamma, mesh))
    rows.update({f"noise/{k}": v for k, v in
                 ns.estimate(stats, b_small=b / 4, b_big=b, mesh=mesh)._asdict().items()})
    whole = GradStats(*(FlatBuffer(_whole(x, mesh), x.layout) for x in stats[:2]), k=4)
    gathered = dict(gsnr_summary(gsnr_scale(whole, cfg.optimizer.gamma), cfg.optimizer.gamma))
    gathered.update({f"noise/{k}": v for k, v in
                     ns.estimate(whole, b_small=b / 4, b_big=b)._asdict().items()})
    step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh, noise_scale=True)[0]
    _, metrics = step(state, batch)
    return {name: {k: float(v[k]) for k in READINGS} for name, v in
            (("rows", rows), ("gathered", gathered), ("step", metrics))}


def _rank(rank, init, out):
    from repro_torch.core.accumulate import rank_split_loss
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    with open(f"{out}/inputs.pkl", "rb") as f:
        jparams, batches = pickle.load(f)
    mesh = make_host_mesh(WORLD, rank, init)
    t = torch.arange(24.0).reshape(6, 4) * (rank + 1)
    res = {"reduce_scatter": mesh.reduce_scatter_(t.clone())}
    for plan in PLANS:
        for case, (name, opt, fresh) in RUNS.items():
            cfg = _port_cfg(plan, name, **opt)
            state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu",
                               mesh=mesh)
            step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh)[0]
            res[plan, case] = []
            for batch, with_stats in zip(batches, fresh):
                state, metrics = step(state, batch, with_stats)
                res[plan, case].append(_snapshot(state, mesh, metrics))
        if rank == 0:  # the k = 2 case's one-card step, split over the rows as the ranks split
            name, opt, fresh = RUNS["vr_lamb k2"]
            cfg = _port_cfg(plan, name, **opt)
            state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu")
            step = make_train_step(cfg, rank_split_loss(make_loss_fn(cfg), WORLD), log_gsnr=True,
                                   device="cpu")[0]
            res[plan, "k2 split"] = []
            for batch, with_stats in zip(batches, fresh):
                state, metrics = step(state, batch, with_stats)
                res[plan, "k2 split"].append(_snapshot(state, None, metrics))
    res["normaliser"] = _normaliser_runs(mesh, jparams)
    res["readings"] = _readings_run(mesh, jparams, batches[0])
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def _jax_runs(jp, batches):
    """{JAX run: [(state, metrics) after each step]} of the single-device
    step with the same k, fresh and stale steps as the case's."""
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtr
    from test_torch_train import _cfgs

    want = {}
    for case in sorted(set(JAX_RUN.values())):
        name, opt, fresh = RUNS[case]
        jcfg, _ = _cfgs("bert-large", "reference", name, **opt)
        jstate = jtr.init_state(jcfg, params=jp)
        jstep = jax.jit(jtr.make_train_step(jcfg, log_gsnr=True)[0], static_argnums=2)
        want[case] = []
        for batch, with_stats in zip(batches, fresh):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, with_stats)
            want[case].append(jax.device_get((jstate, jm)))
    return want


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX runs, the inputs): the ranks
    run while the JAX side computes."""
    import jax

    from repro.data import lm_batches as j_lm_batches
    from repro.models import transformer as jt
    from test_torch_train import _cfgs

    tmp = tmp_path_factory.mktemp("mesh_paths")
    jcfg, _ = _cfgs("bert-large", "reference")
    jp = jax.device_get(jt.init_params(jcfg.model, jax.random.PRNGKey(0)))
    stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
    batches = [next(stream) for _ in range(max(len(f) for _, _, f in RUNS.values()))]
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump((jp, batches), f)
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    want = _jax_runs(jp, batches)
    wait_ranks(ctx, DEADLINE_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, want, (jp, batches)


def test_reduce_scatter_gives_each_rank_its_rows_of_the_sum(mesh_runs):
    ranks, _, _ = mesh_runs
    total = torch.arange(24.0).reshape(6, 4) * 3
    for r, res in enumerate(ranks):
        assert torch.equal(res["reduce_scatter"], total[3 * r: 3 * r + 3])


def test_params_stay_bit_identical_across_ranks(mesh_runs):
    (r0, r1), _, _ = mesh_runs
    for plan in PLANS:
        for case in RUNS:
            for i, (a, b) in enumerate(zip(r0[plan, case], r1[plan, case])):
                assert torch.equal(a["params"], b["params"]), (plan, case, i)
                assert a["metrics"] == b["metrics"], (plan, case, i)


@pytest.mark.parametrize("case", [c for c in RUNS if c != "vr_lamb k2"])
def test_mesh_steps_match_the_single_device_reference(mesh_runs, case):
    from test_torch_train import _compare

    (r0, _), want, _ = mesh_runs
    for plan in PLANS:
        snaps = r0[plan, case]
        assert len(snaps) == len(RUNS[case][2])
        for i, snap in enumerate(snaps):
            _compare(*want[JAX_RUN[case]][i], _as_state(snap), snap["metrics"], i)
            fresh = RUNS[case][2][i] and RUNS[case][0].startswith("vr_")
            assert ("gsnr/mean" in snap["metrics"]) == fresh


def test_two_group_mesh_step_matches_the_single_device_reference(mesh_runs):
    """k = 2: the well-posed part of ``_compare`` (module docstring)."""
    import jax

    from test_torch_train import SCALARS, TOL

    (r0, _), want, _ = mesh_runs
    (jstate, jm), = want["vr_lamb k2"]
    jparams = jax.device_get(jstate.params)
    for plan in PLANS:
        snap, = r0[plan, "vr_lamb k2"]
        for k in SCALARS:
            np.testing.assert_allclose(snap["metrics"][k], float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k} {plan}")
        from repro_torch.train.checkpoint import flat_to_numpy

        got = flat_to_numpy(snap["params"], snap["layout"])
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{path} {plan}", **TOL)
        assert snap["step"] == 1 and snap["opt_state"]["pt"] == 1


def test_two_group_mesh_step_matches_the_one_card_step_split_as_the_ranks(mesh_runs):
    """k = 2, the whole of ``_compare``, against the one-card step that
    rounds the gradient as the mesh does (module docstring); and, as the two
    differ only in the order of the straddling leaves' sums, their metrics,
    params and m, v, p within SPLIT_RTOL."""
    from repro_torch.train.checkpoint import flat_to_numpy
    from test_torch_train import _compare, _state_tree

    (r0, _), _, _ = mesh_runs
    for plan in PLANS:
        runs = r0[plan, "vr_lamb k2"], r0[plan, "k2 split"]
        assert len(runs[0]) == len(runs[1]) == len(RUNS["vr_lamb k2"][2])
        for i, (got, want) in enumerate(zip(*runs)):
            ref = types.SimpleNamespace(
                params=flat_to_numpy(want["params"], want["layout"]), step=want["step"],
                opt_state={k: _state_tree(v) if k in "mvp" else v
                           for k, v in want["opt_state"].items()})
            _compare(ref, want["metrics"], _as_state(got), got["metrics"], i)
            assert got["metrics"].keys() == want["metrics"].keys()
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(got["metrics"][k], v, rtol=SPLIT_RTOL, err_msg=k)
            torch.testing.assert_close(got["params"], want["params"], rtol=SPLIT_RTOL, atol=0)
            for k in "mvp":
                for a, b in zip(*(tree_leaves(run["opt_state"][k]) for run in (got, want))):
                    torch.testing.assert_close(a, b, rtol=SPLIT_RTOL, atol=0, msg=k)


@pytest.mark.parametrize("loss_norm", LOSS_NORMS)
def test_pad_rows_on_one_rank_keep_the_single_card_loss(mesh_runs, loss_norm):
    from repro_torch.core.accumulate import grad_stats
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn

    (r0, r1), _, (jp, _) = mesh_runs
    cfg = _port_cfg("fused", "vr_lamb", loss_norm, k=2)
    state = init_state(cfg, params=params_from_numpy(jp, cfg.model), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _packed_batch(cfg).items()}
    assert (batch["positions"][2::4] < 0).any() and (batch["positions"][0::4] >= 0).all()
    loss, _, stats = grad_stats(make_loss_fn(cfg), state.params, batch, 2,
                                backend=cfg.parallel.backend)
    got_loss, got_mean, own, raised = r0["normaliser"][loss_norm]
    assert raised
    assert r1["normaliser"][loss_norm][0] == got_loss
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    np.testing.assert_allclose(got_mean.numpy(), stats.mean.data.numpy(), rtol=1e-5, atol=1e-8)
    # each rank's own mean, averaged, weighs rank 1's few live tokens as
    # many as rank 0's
    want = stats.mean.data
    assert float((own - want).norm()) > 0.1 * float(want.norm())


def test_readings_under_a_mesh_match_the_single_card_step(mesh_runs):
    """The sums within rtol 1e-5, tr_sigma, g2 and b_simple within the
    bounds that gives them (test_torch_noise_scale.py's ``check_estimate``:
    they are differences of the two close f32 sums), gsnr/* rtol 1e-5."""
    from repro_torch.train import init_state, make_train_step
    from test_torch_noise_scale import check_estimate
    from repro_torch.train.checkpoint import params_from_numpy

    (r0, r1), _, (jp, batches) = mesh_runs
    cfg = _port_cfg("fused", "vr_lamb", k=4)
    state = init_state(cfg, params=params_from_numpy(jp, cfg.model), device="cpu")
    step = make_train_step(cfg, log_gsnr=True, device="cpu", noise_scale=True)[0]
    _, metrics = step(state, batches[0])
    got = r0["readings"]
    assert got == r1["readings"]
    b = cfg.global_batch
    noise = lambda m: {k: m[f"noise/{k}"] for k in NOISE}
    for name, want in (("single-card step", {k: float(v) for k, v in metrics.items()}),
                       ("carry gathered", got["gathered"])):
        check_estimate(noise(got["step"]), noise(want), b / 4, b, 1e-5, what=name)
        for k in GSNR:
            np.testing.assert_allclose(got["step"][k], want[k], rtol=1e-5, err_msg=f"{k} {name}")
    check_estimate(noise(got["rows"]), noise(got["gathered"]), b / 4, b, 1e-5, what="rows")
    for k in GSNR:
        np.testing.assert_allclose(got["rows"][k], got["gathered"][k], rtol=1e-5, err_msg=k)


class _Rank:
    """Rank ``rank`` of a mesh of ``size``: the per-shard sweeps use no
    collective."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


def _sweep(kernel, plan, layout, x, whole):
    """(a shard's result, the whole-buffer op's result) of one sweep; the
    carries start from the same values."""
    from repro_torch.kernels import flat_stats as fs

    sh = plan.shard(layout)
    c = {n: sh.local(x[n]).clone() for n in ("gs", "g2s")}
    if kernel == "K3":
        return (plan.moments_accum(c["gs"], c["g2s"], sh.local(x["g"]), layout),
                fs.flat_moments_accum(whole["gs"], whole["g2s"], x["g"]))
    if kernel == "K9":
        return (plan.g_accum(c["gs"], sh.local(x["g"]), layout),
                fs.flat_g_accum(whole["gs"], x["g"]))
    if kernel == "K4":
        return (plan.moments_finalize(c["gs"], c["g2s"], 3, layout),
                fs.flat_moments_finalize(whole["gs"], whole["g2s"], 3))
    rows = torch.stack([sh.local(s) for s in x["stack"]])
    return plan.vmap_moments(rows, 3, layout), fs.flat_vmap_moments(x["stack"], 3)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("kernel", ["K3", "K9", "K4", "K10"])
def test_per_shard_stats_sweeps_equal_the_whole_buffer_rows(kernel, n_shards):
    from test_torch_optim import _tree

    layout = ParamLayout.for_tree(_tree("hostile"))
    assert layout.n_blocks % n_shards  # the last shard is padded
    rs = np.random.default_rng(n_shards)
    shape = (layout.n_rows, 128)
    x = {n: torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
         for n in ("g", "gs", "g2s")}
    x["g2s"] = x["g2s"].abs()
    x["stack"] = torch.from_numpy(rs.standard_normal((3, *shape)).astype(np.float32))
    for rank in range(n_shards):
        mesh = _Rank(n_shards, rank)
        plan = FlatSpmd(mesh, Rules(mesh=mesh))
        sh = plan.shard(layout)
        assert isinstance(sh, RowShard) and plan.supports(layout)
        whole = {n: x[n].clone() for n in ("gs", "g2s")}
        got, want = _sweep(kernel, plan, layout, x, whole)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.shape == (sh.rows, 128)
            assert torch.equal(a, sh.local(b)), (kernel, n_shards, rank)
            assert not a[sh.real_rows:].any()  # padding rows stay zero


def test_data_axis_without_a_mesh_is_the_microbatch_step():
    from repro_torch.data import lm_batches
    from repro_torch.train import init_state, make_train_step

    out = {}
    for source in ("microbatch", "data_axis"):
        cfg = _port_cfg("fused", "vr_lamb", gsnr_source=source)
        state = init_state(cfg, device="cpu")
        batch = next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len))
        state, metrics = make_train_step(cfg, log_gsnr=True, device="cpu")[0](state, batch)
        out[source] = (state.params.data, state.opt_state, metrics)
    (pa, sa, ma), (pb, sb, mb) = out["microbatch"], out["data_axis"]
    assert torch.equal(pa, pb)
    assert all(torch.equal(sa[k].data, sb[k].data) for k in "mvp")
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
