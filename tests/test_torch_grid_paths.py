"""Port parity of every training path on a (data, model) grid of spawned
gloo ranks beside VR-LAMB's scan step (tests/test_torch_grid.py): the
other nine optimizers, the vmap stats method, the data-axis GSNR source
and the noise readings (train/trainer.py on a launch/mesh.py::GridMesh).

One group of four CPU ranks as a (2, 2) grid (``start_ranks``, one torch
thread each, a rendezvous file under the test's tmp dir) runs the
bert-large smoke in f32 compute on both plans, from the reference's init
params (its numpy tree, each rank keeping its blocks) on the reference's
batches, k = 4:

* Each of the nine optimizers, two fresh steps (VR-Adam with
  ``gsnr_refresh=2``: fresh, stale, fresh), held against the JAX
  ``make_train_step`` on one device with tests/test_torch_train.py's
  ``_compare`` (loss, grad_norm, update_norm, gsnr/*, params and m, v, p,
  gathered whole).  The baseline ``sgd`` has a case of its own: on a grid
  the gathers' adjoint already sums the data ranks' gradients into each
  rank's blocks, and an all-reduce over the data axis on top (what
  ``grad_only`` did under a mesh) adds different blocks together.
* VR-LAMB with ``stats_method="vmap"`` and ``noise_scale=True`` (the
  microbatch source's readings), one fresh step, against the JAX k = 4
  scan step, which the reference's vmap method equals, with its readings
  (``_hold``: ``_compare`` and noise/* through
  tests/test_torch_noise_scale.py's ``check_estimate`` at NOISE_RTOL).
* VR-LAMB with ``gsnr_source="data_axis"`` and the readings, one fresh step,
  k = D = 2, against the JAX k = 2 microbatch step (whose groups are the
  data ranks' rows) and the port's one-card k = 2 step, which rank 0 runs:
  loss, grad_norm, update_norm, params and noise/*, and the moments
  themselves (mean and sq_mean gathered whole, within MOMENT_RTOL of the
  one-card step's: sq_mean is the mean of each data rank's squared
  gradient, so a square taken after the data axis's sum fails it).  Not
  gsnr/* nor m, v, p: with two groups the GSNR of an element is
  ((g0 + g1) / (g0 - g1))^2, whose leaf means a few cancelling elements
  set, and the model axis's f32 partial sums round each group's gradient
  otherwise than one card's products (the first run read gsnr/mean
  0.115304 on the grid against 0.116046 on one card, past ``_compare``'s
  5e-4; the grid's own fused and reference plans differ by as much), as
  tests/test_torch_mesh_paths.py's docstring sets out for k = 2.
* Launches per rank and step (the kernel wrappers' calls counted on the
  fused plan), as the grid's table says: K1 twice and K2 once per layer
  per backward pass (the vmap method once each per layer for all k groups:
  no remat under ``torch.func``), K3 k and K4 (K9 k on a stale step), K13
  and the update's kernel (K14 VR-SGD/Momentum, K15 VR-Adam, K16 VR-LAMB,
  K17 VR-LARS, with ``trust_apply`` for LAMB and LARS), K10 for the vmap
  method, K11 once for the data-axis source; none of the VR kernels for
  a baseline.
* The collectives: the vmap method's forward and backward over k groups
  issue exactly the collectives of ONE group's scan forward and backward
  (remat off for the scan, so both gather each layer's weights once), not
  k times as many; the data-axis step reduces its payload in one
  reduce-scatter over the data axis and all-reduces nothing over it but
  the loss.
* Every leaf block bit-identical on the ranks that hold it, after every
  step of every case.
* Two planted faults, each of which must make ``_hold`` fail: LARS's trust
  norms taken over the rank's blocks instead of the whole leaves, and the
  noise readings' per-leaf sums all-reduced without the owner weights (a
  leaf replicated over M model ranks then counts M times).
* The checkpoint: VR-LARS's (m), VR-Adam's (m, v, p) and Adam's (tree m,
  v) state saved from the grid restores whole into a one-card template,
  equal to the state gathered whole, and back into a grid template from
  another seed, each rank's blocks equal to its own.

The rank function lives in this module and the ranks import it, so JAX is
imported inside the test functions only.  The ranks start first and wait
for their inputs, which the parent draws with JAX meanwhile; the JAX steps
compile through tests/torch_fast_jit.py, one per optimizer (and fresh or
stale), shared by both plans.
"""
import dataclasses
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import start_ranks, wait_ranks

GRID = (2, 2)
WORLD = GRID[0] * GRID[1]
DEADLINE_S = 300.0
PLANS = ("fused", "reference")
K = 4
N_LAYERS = 2  # the bert-large smoke's
TWO = (True, True)
BASELINES = ("sgd", "momentum", "adam", "lars", "lamb")
# case -> (optimizer, OptimizerConfig overrides, fresh flag of each step,
#          noise_scale, the JAX run it is held against)
RUNS = {
    **{name: (name, {}, TWO, False, name) for name in
       BASELINES + ("vr_sgd", "vr_momentum", "vr_lars")},
    "vr_adam": ("vr_adam", {"gsnr_refresh": 2}, (True, False, True), False, "vr_adam"),
    "vr_lamb vmap": ("vr_lamb", {"stats_method": "vmap"}, (True,), True, "vr_lamb k4"),
    "vr_lamb data_axis": ("vr_lamb", {"gsnr_source": "data_axis"}, (True,), True,
                          "vr_lamb k2"),
}
# JAX run -> (optimizer, overrides, fresh flags, noise_scale)
JAX_RUNS = {
    **{name: (name, {}, RUNS[name][2], False) for name in
       BASELINES + ("vr_sgd", "vr_momentum", "vr_lars", "vr_adam")},
    "vr_lamb k4": ("vr_lamb", {}, (True,), True),
    "vr_lamb k2": ("vr_lamb", {"k": 2}, (True,), True),
}
JAX_RUNS["vr_adam"] = ("vr_adam", {"gsnr_refresh": 2}, RUNS["vr_adam"][2], False)
CKPT = ("vr_lars", "vr_adam", "adam")
NOISE = ("g2_small", "g2_big", "tr_sigma", "g2", "b_simple")
# noise/g2_small and noise/g2_big against another implementation's: sums of
# the squared f32 gradients in another order (the data-axis step read
# g2_big 4.1e-6 from the fused one-card step's, whose f32 dot runs over the
# whole buffer); the derived readings within the bounds that gives them
NOISE_RTOL = 1e-5
# the data-axis moments gathered whole against the one-card k = 2 step's,
# ||grid - one card|| / ||one card|| (f32 sums in another order; the first
# run read 7.3e-7 for mean and 8.5e-7 for sq_mean)
MOMENT_RTOL = 1e-5
# the kernel wrappers counted on the fused plan: (module, name, table key)
KERNELS = (
    ("repro_torch.kernels.flash_attention", "flash_attention", "K1"),
    ("repro_torch.kernels.flash_attention_bwd", "flash_attention_bwd", "K2"),
    ("repro_torch.kernels.flat_stats", "flat_moments_accum", "K3"),
    ("repro_torch.kernels.flat_stats", "flat_moments_finalize", "K4"),
    ("repro_torch.kernels.flat_stats", "flat_g_accum", "K9"),
    ("repro_torch.kernels.flat_stats", "flat_vmap_moments", "K10"),
    ("repro_torch.kernels.flat_stats", "flat_pack_square", "K11"),
    ("repro_torch.core.distributed", "flat_pack_square", "K11"),
    ("repro_torch.kernels.flat_spmd", "leaf_r_partials", "K13"),
    ("repro_torch.kernels.flat_spmd", "vr_scale_apply", "K14"),
    ("repro_torch.kernels.flat_spmd", "vr_adam_apply", "K15"),
    ("repro_torch.kernels.flat_spmd", "vr_lamb_compute", "K16"),
    ("repro_torch.kernels.flat_spmd", "vr_lars_compute", "K17"),
    ("repro_torch.kernels.flat_spmd", "trust_apply", "trust_apply"),
)
UPDATE = {"vr_sgd": "K14", "vr_momentum": "K14", "vr_adam": "K15", "vr_lamb": "K16",
          "vr_lars": "K17"}


def want_launches(case, fresh):
    """The table's launches of one rank's fused step."""
    name, opt = RUNS[case][:2]
    vmap = opt.get("stats_method") == "vmap"
    data_axis = opt.get("gsnr_source") == "data_axis" and fresh
    passes = 1 if (name in BASELINES or data_axis or vmap) else K
    want = {"K1": (1 if vmap else 2) * N_LAYERS * passes, "K2": N_LAYERS * passes}
    if name in BASELINES:
        return want
    if vmap:
        want["K10"] = 1
    elif data_axis:
        want["K11"] = 1
    elif fresh:
        want.update(K3=K, K4=1)
    else:
        want["K9"] = K
    if fresh:
        want.update(K13=1, **{UPDATE[name]: 1})
    if name in ("vr_lamb", "vr_lars"):
        want["trust_apply"] = 1
    return want


class _Launches:
    """Counting wrappers around the kernel wrappers (their plain versions
    run on the CPU, where the wrappers' own counters stay at 0)."""

    def __init__(self):
        import importlib

        self.counts = {}
        for mod, name, key in KERNELS:
            module = importlib.import_module(mod)
            fn = getattr(module, name)
            fn = getattr(fn, "counted", fn)
            setattr(module, name, self._wrap(fn, key))

    def _wrap(self, fn, key):
        def counted(*args, **kw):
            self.counts[key] = self.counts.get(key, 0) + 1
            return fn(*args, **kw)

        counted.counted = fn
        return counted

    def take(self):
        out, self.counts = self.counts, {}
        return out


class _Collectives:
    """The grid's collectives of one call, as (kind, axes) in call order."""

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, []

    def __enter__(self):
        m = self.mesh
        for kind in ("all_gather", "reduce_scatter_", "all_reduce_"):
            fn = getattr(m, kind)

            def rec(t, axes=None, *a, _fn=fn, _kind=kind, **kw):
                self.calls.append((_kind, m._axes(m.axis_names if axes is None else axes)))
                return _fn(t, axes, *a, **kw)

            setattr(m, kind, rec)
        return self

    def __exit__(self, *exc):
        for kind in ("all_gather", "reduce_scatter_", "all_reduce_"):
            delattr(self.mesh, kind)


def _port_cfg(plan, name, **opt):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    cfg = get_smoke("bert-large")
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    return cfg.replace(
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=bk),
        optimizer=dataclasses.replace(cfg.optimizer, name=name, **opt))


def _run(mesh, cfg, jparams, batches, fresh, noise, launches):
    """(state, a snapshot per step, launches per step) of the grid's steps.
    Only rank 0 keeps the whole params and state it gathered (every rank
    gathers the same); the others keep their metrics and blocks."""
    from test_torch_grid import _snapshot

    from repro_torch.train import init_state, make_train_step

    state = init_state(cfg, params=jparams, device="cpu", mesh=mesh)
    step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh, noise_scale=noise)[0]
    snaps, counts = [], []
    for batch, with_stats in zip(batches, fresh):
        launches.take()
        state, metrics = step(state, batch, with_stats)
        counts.append(launches.take())
        snap = _snapshot(state, metrics)
        if mesh.rank != 0:
            snap = {k: snap[k] for k in ("metrics", "local", "step")}
        snaps.append(snap)
    return state, snaps, counts


def _checkpoint(mesh, cfg, state, path):
    """Save the grid state; restore it into a grid template from another
    seed: whether every rank's blocks came back equal."""
    from repro_torch.core.layout import is_flat, pad_mask, tree_leaves
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore, save

    save(path, state, mesh=mesh)
    back = restore(path, init_state(cfg.replace(seed=1), device="cpu", mesh=mesh))
    live = pad_mask(state.params.local_layout)
    ok = torch.equal(back.params.data, state.params.data) and back.step == state.step
    for nm in sorted(set("mvp") & set(state.opt_state)):
        a, b = back.opt_state[nm], state.opt_state[nm]
        if is_flat(b):
            ok = ok and a.shard.specs == b.shard.specs and torch.equal(a.data[live], b.data[live])
        else:
            ok = ok and all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return ok


def _data_axis_moments(mesh, plan, jparams, batch):
    """On rank 0 ((mean, sq_mean) of the data-axis source on the grid,
    gathered whole, and those of the one-card k = 2 step); None elsewhere."""
    from repro_torch.core.accumulate import grad_stats
    from repro_torch.core.distributed import device_grad_stats_fn
    from repro_torch.core.layout import is_flat
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.loss import make_loss_fn
    from repro_torch.train.trainer import grid_plan
    from test_torch_grid import _whole

    cfg = _port_cfg(plan, "vr_lamb", gsnr_source="data_axis")
    bk = cfg.parallel.backend
    pl, spmd = grid_plan(cfg, mesh)
    params = init_state(cfg, params=jparams, device="cpu", mesh=mesh).params
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    stats = device_grad_stats_fn(make_loss_fn(cfg, pl), mesh, backend=bk, spmd=spmd)(params,
                                                                                      tb)[2]
    grid = tuple(_whole(x, params.shard).data for x in stats[:2])
    if mesh.rank != 0:
        return None
    state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu")
    stats = grad_stats(make_loss_fn(cfg), state.params, tb, 2, backend=bk)[2]
    return grid, tuple(x.data if is_flat(x) else state.params.layout.pack(x) for x in stats[:2])


def _planted_lars_trust(self, g, p, trust, wd):
    """GridSpmd.tree_lars_trust with each block's own norms."""
    from repro_torch.core.baselines import lars_trust
    from repro_torch.core.layout import tree_map

    return tree_map(lambda g_, p_: lars_trust(g_, p_, trust, wd), g, p)


def _planted_grid_sums(per_leaf, grid):
    """noise_scale._grid_sums without the owner weights."""
    return grid.mesh.all_reduce_(per_leaf.clone())


def _collective_runs(mesh, jparams, batch):
    """{"vmap": collectives of the vmap method's k groups, "scan": of one
    group's scan forward and backward (remat off), "data_axis": of the
    data-axis source's statistics, with its K11 launches}."""
    from repro_torch.core.accumulate import _rank_groups, grad_stats, split_batch
    from repro_torch.core.distributed import device_grad_stats_fn
    from repro_torch.train import init_state
    from repro_torch.train.loss import make_loss_fn
    from repro_torch.train.trainer import grid_plan

    out = {}
    cfg = _port_cfg("fused", "vr_lamb")
    pl, spmd = grid_plan(cfg, mesh)
    loss_fn = make_loss_fn(cfg, pl)
    params = init_state(cfg, params=jparams, device="cpu", mesh=mesh).params
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with _Collectives(mesh) as c:
        grad_stats(loss_fn, params, tb, K, method="vmap", backend=cfg.parallel.backend,
                   spmd=spmd)
    out["vmap"] = c.calls[:-1]  # the loss's mean over the data ranks last
    mb = _rank_groups(loss_fn, split_batch(tb, K), spmd.batch_mesh)
    params.zero_grad()
    with pl.without_remat(), _Collectives(mesh) as c:
        loss_fn(params.tree, {name: x[0] for name, x in mb.items()})[0].backward()
    out["scan"] = c.calls
    launches = _Launches()
    fn = device_grad_stats_fn(loss_fn, mesh, backend=cfg.parallel.backend, spmd=spmd)
    with _Collectives(mesh) as c:
        fn(params, tb)
    out["data_axis"] = (c.calls, launches.take())
    return out


def _rank(rank, init, out):
    from repro_torch.backend import GridSpmd
    from repro_torch.core import noise_scale as ns
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.checkpoint import params_from_numpy

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    mesh = init_grid_mesh("gloo", *GRID, "cpu", init_method=init, rank=rank)
    end = time.monotonic() + DEADLINE_S
    while not os.path.exists(f"{out}/inputs.pkl") and time.monotonic() < end:
        time.sleep(0.1)
    with open(f"{out}/inputs.pkl", "rb") as f:
        jparams, batches = pickle.load(f)
    launches = _Launches()
    res = {"coords": dict(mesh.coords)}
    for plan in PLANS:
        for case, (name, opt, fresh, noise, _) in RUNS.items():
            cfg = _port_cfg(plan, name, **opt)
            state, res[plan, case], res[plan, case, "launches"] = _run(
                mesh, cfg, jparams, batches, fresh, noise, launches)
            if plan == "fused" and case in CKPT:
                res["ckpt", case] = _checkpoint(mesh, cfg, state, f"{out}/{case}.npz")
            del state
    if rank == 0:  # the data-axis case's one-card k = 2 step
        for plan in PLANS:
            cfg = _port_cfg(plan, "vr_lamb", k=2)
            state = init_state(cfg, params=params_from_numpy(jparams, cfg.model), device="cpu")
            step = make_train_step(cfg, log_gsnr=True, device="cpu", noise_scale=True)[0]
            state, metrics = step(state, batches[0])
            res[plan, "k2 one card"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": state.params.data.clone(), "layout": state.params.layout,
                "step": state.step}
    for plan in PLANS:
        res[plan, "data_axis moments"] = _data_axis_moments(mesh, plan, jparams, batches[0])
    orig = GridSpmd.tree_lars_trust
    GridSpmd.tree_lars_trust = _planted_lars_trust
    try:
        res["planted lars"] = _run(mesh, _port_cfg("fused", "lars"), jparams, batches[:1],
                                   (True,), False, launches)[1]
    finally:
        GridSpmd.tree_lars_trust = orig
    orig = ns._grid_sums
    ns._grid_sums = _planted_grid_sums
    try:
            res["planted noise"] = _run(mesh, _port_cfg("fused", "vr_lamb", stats_method="vmap"),
                                    jparams, batches[:1], (True,), True, launches)[1]
    finally:
        ns._grid_sums = orig
    res["collectives"] = _collective_runs(mesh, jparams, batches[0])
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def _jax_runs(jp, batches):
    """{JAX run: [(state, metrics) after each step]} of the single-device
    step, one compile per optimizer and fresh flag."""
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtr
    from test_torch_train import _cfgs
    from torch_fast_jit import fast_jit

    want = {}
    for run, (name, opt, fresh, noise) in JAX_RUNS.items():
        jcfg, _ = _cfgs("bert-large", "reference", name, **opt)
        jstate = jtr.init_state(jcfg, params=jp)
        step = jtr.make_train_step(jcfg, log_gsnr=True, noise_scale=noise)[0]
        jstep = {f: fast_jit(lambda s, b, f=f: step(s, b, f)) for f in set(fresh)}
        want[run] = []
        for batch, with_stats in zip(batches, fresh):
            jstate, jm = jstep[with_stats](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            want[run].append(jax.device_get((jstate, jm)))
    return want


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """(every rank's results, the JAX runs, the inputs, the tmp dir): the
    ranks run while the JAX side computes."""
    import jax

    from repro.data import lm_batches as j_lm_batches
    from repro.models import transformer as jt
    from test_torch_train import _cfgs

    tmp = tmp_path_factory.mktemp("grid_paths")
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    jcfg, _ = _cfgs("bert-large", "reference")
    jp = jax.device_get(jt.init_params(jcfg.model, jax.random.PRNGKey(0)))
    stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
    batches = [next(stream) for _ in range(3)]
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump((jp, batches), f)
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
    want = _jax_runs(jp, batches)
    wait_ranks(ctx, DEADLINE_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r in range(WORLD):  # the checkpoints stay for their tests
        os.remove(tmp / f"rank{r}.pt")
    return ranks, want, (jp, batches), tmp


def _noise(m):
    return {k: m[f"noise/{k}"] for k in NOISE}


def _hold(jstate, jm, snap, step, b_small):
    """``_compare`` of one step and, where the step took the readings, its
    noise/* against the JAX step's (``check_estimate``)."""
    from test_torch_distributed import _as_state
    from test_torch_noise_scale import check_estimate
    from test_torch_train import _compare

    tm = snap["metrics"]
    _compare(jstate, jm, _as_state(snap), tm, step)
    if "noise/g2_small" in tm:
        b = 8  # the smoke's global batch
        check_estimate(_noise(tm), {k: float(v) for k, v in _noise(jm).items()}, b_small, b,
                       NOISE_RTOL, what=f"step {step}")


@pytest.mark.parametrize("case", [c for c in RUNS if c not in ("sgd", "vr_lamb data_axis")])
def test_grid_paths_match_the_single_device_reference(grid_runs, case):
    ranks, want, _, _ = grid_runs
    name, _, fresh, noise, run = RUNS[case]
    for plan in PLANS:
        snaps = ranks[0][plan, case]
        assert len(snaps) == len(fresh)
        for i, snap in enumerate(snaps):
            _hold(*want[run][i], snap, i, b_small=8 / K)
            assert ("gsnr/mean" in snap["metrics"]) == (fresh[i] and name.startswith("vr_"))
            assert ("noise/b_simple" in snap["metrics"]) == noise
            for r, res in enumerate(ranks):
                assert res[plan, case][i]["metrics"] == snap["metrics"], (plan, r, i)


def test_baseline_step_takes_each_rank_blocks_gradient_once(grid_runs):
    """The baseline ``sgd`` (module docstring: one all-reduce of the data
    ranks' blocks on top of the gathers' adjoint would add different blocks
    together): both steps of both plans against the JAX step."""
    ranks, want, _, _ = grid_runs
    for plan in PLANS:
        for i, snap in enumerate(ranks[0][plan, "sgd"]):
            _hold(*want["sgd"][i], snap, i, b_small=8 / K)
            assert all(res[plan, "sgd"][i]["metrics"] == snap["metrics"] for res in ranks)


def test_data_axis_source_matches_the_two_group_steps(grid_runs):
    """k = D = 2 against the JAX k = 2 step and the port's one-card k = 2
    step: the well-posed readings and the moments (module docstring)."""
    import jax

    from repro_torch.core.layout import tree_paths
    from repro_torch.train.checkpoint import flat_to_numpy
    from test_torch_noise_scale import check_estimate
    from test_torch_train import SCALARS, TOL

    ranks, want, _, _ = grid_runs
    (jstate, jm), = want["vr_lamb k2"]
    jm = {k: float(v) for k, v in jm.items()}
    for plan in PLANS:
        one = ranks[0][plan, "k2 one card"]
        (mean, sq), (mean1, sq1) = ranks[0][plan, "data_axis moments"]
        snap, = ranks[0][plan, "vr_lamb data_axis"]
        tm = snap["metrics"]
        assert all(res[plan, "vr_lamb data_axis"][0]["metrics"] == tm for res in ranks)
        got = flat_to_numpy(snap["params"], snap["layout"])
        for name, m, params in (("JAX", jm, jax.device_get(jstate.params)),
                                ("one card", one["metrics"],
                                 flat_to_numpy(one["params"], one["layout"]))):
            for k in SCALARS:
                np.testing.assert_allclose(tm[k], m[k], rtol=1e-5, err_msg=f"{k} {plan} {name}")
            for (path, a), (_, b) in zip(tree_paths(got), tree_paths(params)):
                np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{path} {plan} {name}",
                                           **TOL)
            check_estimate(_noise(tm), _noise(m), 4, 8, NOISE_RTOL, what=f"{plan} {name}")
        for a, b, what in ((mean, mean1, "mean"), (sq, sq1, "sq_mean")):
            gap = float((a - b).norm() / b.norm())
            assert gap <= MOMENT_RTOL, (plan, what, gap)


@pytest.mark.parametrize("case", list(RUNS))
def test_launches_per_rank_follow_the_grid_table(grid_runs, case):
    ranks, _, _, _ = grid_runs
    fresh = RUNS[case][2]
    for res in ranks:
        for i, counts in enumerate(res["fused", case, "launches"]):
            assert counts == want_launches(case, fresh[i]), (case, i)
        for counts in res["reference", case, "launches"]:
            assert counts == {}, counts


@pytest.mark.parametrize("case", list(RUNS))
def test_replicas_of_each_block_stay_bit_identical(grid_runs, case):
    from repro_torch.configs import get_smoke
    from repro_torch.core.layout import ParamLayout
    from repro_torch.models.transformer import model_layout
    from repro_torch.sharding.placement import shard_shape
    from repro_torch.sharding.rules import Rules

    ranks, _, _, _ = grid_runs
    layout = model_layout(get_smoke("bert-large").model)
    sizes = {"data": GRID[0], "model": GRID[1]}
    rules = Rules(mesh=types.SimpleNamespace(shape=sizes, axis_names=("data", "model")))
    specs = [rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)]
    local = ParamLayout(layout.paths, tuple(shard_shape(s, sp, sizes)
                                            for s, sp in zip(layout.shapes, specs)))
    for plan in PLANS:
        for i in range(len(RUNS[case][2])):
            views = [local.leaf_views(res[plan, case][i]["local"]) for res in ranks]
            for n, spec in enumerate(specs):
                for a in range(WORLD):
                    for b in range(a + 1, WORLD):
                        ca, cb = ranks[a]["coords"], ranks[b]["coords"]
                        if all(ca[x] == cb[x] for x in spec.axes()):
                            assert torch.equal(views[a][n], views[b][n]), (plan, i, n, a, b)


def test_planted_block_norms_in_lars_fail(grid_runs):
    ranks, want, _, _ = grid_runs
    _hold(*want["lars"][0], ranks[0]["fused", "lars"][0], 0, b_small=8 / K)
    with pytest.raises(AssertionError):
        _hold(*want["lars"][0], ranks[0]["planted lars"][0], 0, b_small=8 / K)


def test_planted_noise_sums_without_owner_weights_fail(grid_runs):
    ranks, want, _, _ = grid_runs
    _hold(*want["vr_lamb k4"][0], ranks[0]["fused", "vr_lamb vmap"][0], 0, b_small=8 / K)
    with pytest.raises(AssertionError):
        _hold(*want["vr_lamb k4"][0], ranks[0]["planted noise"][0], 0, b_small=8 / K)


def test_vmap_method_issues_one_group_of_collectives_for_all_k(grid_runs):
    ranks, _, _, _ = grid_runs
    for res in ranks:
        vmap, scan = res["collectives"]["vmap"], res["collectives"]["scan"]
        gathers = [c for c in scan if c[0] == "all_gather"]
        assert len(gathers) >= 2 * N_LAYERS  # each layer's weights gathered
        assert sorted(vmap) == sorted(scan), (vmap, scan)


def test_data_axis_source_reduces_its_payload_in_one_collective(grid_runs):
    ranks, _, _, _ = grid_runs
    for res in ranks:
        calls, launches = res["collectives"]["data_axis"]
        assert launches == {"K11": 1, "K1": 2 * N_LAYERS, "K2": N_LAYERS}, launches
        over_data = [c for c in calls if "data" in c[1] and c[0] != "all_gather"]
        # the payload's reduce-scatter, then the loss's mean over the data ranks
        assert over_data == [("reduce_scatter_", ("data",)), ("all_reduce_", ("data",))], calls


@pytest.mark.parametrize("case", CKPT)
def test_grid_checkpoint_of_each_state_restores_whole_and_into_the_grid(grid_runs, case):
    from repro_torch.core.layout import is_flat, pad_mask, tree_leaves
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore

    ranks, _, _, tmp = grid_runs
    assert all(res["ckpt", case] for res in ranks)
    name, opt, fresh = RUNS[case][:3]
    last = ranks[0]["fused", case][-1]
    back = restore(str(tmp / f"{case}.npz"),
                   init_state(_port_cfg("fused", name, **opt), device="cpu"))
    assert torch.equal(back.params.data, last["params"])
    assert back.step == last["step"] == len(fresh)
    live = pad_mask(back.params.layout)
    names = sorted(set("mvp") & set(back.opt_state))
    assert names == (["m"] if case == "vr_lars" else ["m", "v"] if case == "adam" else
                     ["m", "p", "v"])
    for nm in names:
        got, whole = back.opt_state[nm], last["opt_state"][nm].data
        if is_flat(got):
            assert torch.equal(got.data[live], whole[live]), nm
        else:
            flat = back.params.layout.pack(got)
            assert torch.equal(flat[live], whole[live]), nm
