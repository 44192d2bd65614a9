"""Port parity of expert parallelism on a (data, model) grid of spawned
gloo ranks: mixtral's and llama4's MoE blocks with their expert weights
sharded by the reference's rule (models/moe.py::apply_moe_grid,
sharding/placement.py, train/trainer.py on a launch/mesh.py::GridMesh).

One group of four CPU ranks as a (2, 2) grid (``start_ranks``, one torch
thread each, a rendezvous file under the test's tmp dir) runs the MoE
smokes in f32 compute, from the reference's init params (its numpy tree,
each rank keeping its blocks) on the reference's batches, k = 4 (global
batch 8, seq 32: each data rank takes one row of a group):

* (a) the mixtral smoke (4 experts, top-2: the model axis splits the
  experts), VR-LAMB on the fused plan, ``gsnr_refresh=2``: fresh, stale,
  fresh;
* (b) the llama4 smoke (4 experts, top-1, one shared expert, which takes
  the dense MLP's tensor-parallel path), the reference plan, two fresh
  steps;
* (c) the mixtral smoke with 3 experts and ``capacity_factor=0.5``: the
  model axis does not divide the experts, so it splits each expert's d_ff
  (the rule's fallback), and about half the choices are dropped; the fused
  plan, one step;
* (d) the mixtral smoke by the vmap stats method, one step, against (a)'s
  first JAX step (the reference's vmap method equals its scan);
* (e) the mixtral smoke with the data-axis source (k = D = 2), one step,
  against the JAX k = 2 microbatch step, whose groups are the data ranks'
  rows: every MoE reading is then the rank's own (local capacity), as the
  reference's ``shard_map`` computes them.  Its loss, norms, params and MoE
  readings are held; not its gsnr/* nor m, v, p (k = 2's conditioning,
  tests/test_torch_grid_paths.py's docstring).

Each step is held against the JAX ``make_train_step`` on one device with
tests/test_torch_train.py's ``_compare`` (loss, grad_norm, update_norm,
gsnr/*, params and m, v, p gathered whole), and moe_lb_loss, moe_z_loss
and moe_util within MOE_RTOL.  The JAX step routes each microbatch whole:
the capacity counts its tokens, a choice's slot is its prefix count in the
group's token order and the load-balance fractions are the group's, which
the grid takes from one all-gather of the data ranks' counts.

* Routing: before each step every rank routes its rows of each group at
  the step's params (a no-grad grid forward, the step's mode), and the
  JAX forward routes each group at its params; the decisions that differ
  (a token's top-k set) are counted over every group and layer: none in
  f32.  The model ranks of a data row route alike.
* Launches per rank and step on the fused plan (the kernel wrappers'
  calls counted): the dense grid's (tests/test_torch_grid_paths.py).
* Every leaf block bit-identical on the ranks that hold it, after every
  step of every case.
* Two planted faults, each of which must make the check fail: the slots
  taken without the lower data ranks' offsets, with the capacity of the
  rank's own tokens (case (c), where drops make slots matter); and the
  load-balance loss's mean probability all-reduced over the data axis
  with an identity backward, which hands the router 1/D of that loss's
  gradient: its m must move past ``_compare``'s bound on the router leaf
  (case (a)'s first step, at the smoke's router_aux_weight).
* The checkpoint: case (a)'s state saved from the grid restores whole
  into a one-card template, equal to the state gathered whole, and back
  into a grid template from another seed, each rank's blocks equal to its
  own.

The rank function lives in this module and the ranks import it, so JAX is
imported inside the test functions only.  The ranks start first and wait
for their inputs, which the parent draws with JAX meanwhile; the JAX steps
compile through tests/torch_fast_jit.py.
"""
import contextlib
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
K = 4
N_LAYERS = 2  # the MoE smokes'
MIXTRAL, LLAMA4 = "mixtral-8x22b", "llama4-maverick-400b-a17b"
TP_FALLBACK = {"n_experts": 3, "capacity_factor": 0.5}
# model -> (arch, MoEConfig overrides); each draws the reference's init params
MODELS = {"mixtral": (MIXTRAL, {}), "llama4": (LLAMA4, {}), "mixtral e3": (MIXTRAL, TP_FALLBACK)}
# case -> (model, plan, OptimizerConfig overrides, fresh flag of each step,
#          the JAX run it is held against)
RUNS = {
    "mixtral ep": ("mixtral", "fused", {"gsnr_refresh": 2}, (True, False, True), "mixtral"),
    "llama4 shared": ("llama4", "reference", {}, (True, True), "llama4"),
    "mixtral tp fallback": ("mixtral e3", "fused", {}, (True,), "mixtral e3"),
    "mixtral vmap": ("mixtral", "fused", {"stats_method": "vmap"}, (True,), "mixtral"),
    "mixtral data_axis": ("mixtral", "fused", {"gsnr_source": "data_axis"}, (True,),
                          "mixtral k2"),
}
# JAX run -> (model, OptimizerConfig overrides, fresh flags)
JAX_RUNS = {
    "mixtral": ("mixtral", {"gsnr_refresh": 2}, (True, False, True)),
    "llama4": ("llama4", {}, (True, True)),
    "mixtral e3": ("mixtral e3", {}, (True,)),
    "mixtral k2": ("mixtral", {"k": 2}, (True,)),
}
MOE_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_util")
# the MoE readings against the JAX step's: f32 means of router statistics
# in another summation order
MOE_RTOL = 1e-5


def want_launches(case, fresh):
    """The dense grid table's launches of one rank's fused VR-LAMB step (the
    kernel wrappers' calls, tests/test_torch_grid_paths.py's ``_Launches``)."""
    opt = RUNS[case][2]
    vmap = opt.get("stats_method") == "vmap"
    data_axis = opt.get("gsnr_source") == "data_axis" and fresh
    passes = 1 if (data_axis or vmap) else K
    want = {"K1": (1 if vmap else 2) * N_LAYERS * passes, "K2": N_LAYERS * passes}
    if vmap:
        want["K10"] = 1
    elif data_axis:
        want["K11"] = 1
    elif fresh:
        want.update(K3=K, K4=1)
    else:
        want["K9"] = K
    if fresh:
        want.update(K13=1, K16=1)
    want["trust_apply"] = 1
    return want


def _port_cfg(model, plan, **opt):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    arch, moe = MODELS[model]
    cfg = get_smoke(arch)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    model = dataclasses.replace(cfg.model, moe=dataclasses.replace(cfg.model.moe, **moe))
    return cfg.replace(
        model=model,
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=bk),
        optimizer=dataclasses.replace(cfg.optimizer, **{"name": "vr_lamb", "k": K, **opt}))


def _jax_cfg(model, **opt):
    from test_torch_train import _cfgs

    arch, moe = MODELS[model]
    jcfg, _ = _cfgs(arch, "reference", "vr_lamb", **{"k": K, **opt})
    model = dataclasses.replace(jcfg.model, moe=dataclasses.replace(jcfg.model.moe, **moe))
    return jcfg.replace(model=model)


def _routes(mesh, cfg, state, batch):
    """This rank's routing at the state's params, as the step's forward
    routes it: [group][MoE layer] -> (its tokens, top_k) experts of its rows
    of each of the k groups (the data-axis source: its rows, one group, each
    reading its own)."""
    from repro_torch.core.accumulate import _rank_rows, split_batch
    from repro_torch.core.layout import LANE
    from repro_torch.models import moe
    from repro_torch.models.transformer import forward_grid
    from repro_torch.sharding.placement import PayloadSink
    from repro_torch.train.trainer import grid_plan

    pl, _ = grid_plan(cfg, mesh)
    data = mesh.axis("data")
    params = state.params
    tokens = torch.as_tensor(batch["tokens"])
    local = cfg.optimizer.gsnr_source == "data_axis"
    groups = [tokens] if local else list(split_batch({"t": tokens}, cfg.optimizer.k)["t"])
    calls, orig = [], moe._router

    def record(p, xf, c):
        out = orig(p, xf, c)
        calls.append(out[3].numpy().copy())
        return out

    out = []
    moe._router = record
    try:
        for g in groups:
            sink = PayloadSink(torch.zeros((data.size, params.shard.rows, LANE)), params.data)
            with torch.no_grad(), (pl.deferred(sink) if local else contextlib.nullcontext()):
                forward_grid(cfg.model, cfg.parallel, params.tree,
                             _rank_rows(g, data.size, data.rank, 0), pl)
            out.append(list(calls))
            calls.clear()
    finally:
        moe._router = orig
    return out


def _run(mesh, cfg, jparams, batches, fresh, launches, routes=True):
    """(state, a snapshot per step, launches per step, routes per step) of
    the grid's steps.  Only rank 0 keeps the whole params and state it
    gathered; the others keep their metrics and blocks."""
    from test_torch_grid import _snapshot

    from repro_torch.train import init_state, make_train_step

    state = init_state(cfg, params=jparams, device="cpu", mesh=mesh)
    step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh)[0]
    snaps, counts, route_log = [], [], []
    for batch, with_stats in zip(batches, fresh):
        if routes:
            route_log.append(_routes(mesh, cfg, state, batch))
        launches.take()
        state, metrics = step(state, batch, with_stats)
        counts.append(launches.take())
        snap = _snapshot(state, metrics)
        if mesh.rank != 0:
            snap = {k: snap[k] for k in ("metrics", "local", "step")}
        snaps.append(snap)
    return state, snaps, counts, route_log


_ORIG_COUNTS = None


def _planted_counts(pl, counts, n, cfg):
    """moe._grid_counts with each rank's slots counted from 0 and the
    capacity of its own tokens."""
    from repro_torch.models.moe import capacity

    offset, _, total, n_all = _ORIG_COUNTS(pl, counts, n, cfg)
    return torch.zeros_like(offset), capacity(n, cfg), total, n_all


class _SumIdentity(torch.autograd.Function):
    """All-reduce over the data axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(), "data")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _planted_mean_prob(pl, probs):
    """moe._mean_prob as the global mean, all-reduced with an identity
    backward: each rank's loss then holds the whole load-balance loss, and
    its gradient reaches the router x 1/D."""
    d = pl.mesh.shape["data"]
    return _SumIdentity.apply(probs.sum(dim=0), pl.mesh) / (probs.shape[0] * d)


def _rank(rank, init, out):
    global _ORIG_COUNTS
    from test_torch_grid import _checkpoint
    from test_torch_grid_paths import _Launches

    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import moe

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    mesh = init_grid_mesh("gloo", *GRID, "cpu", init_method=init, rank=rank)
    end = time.monotonic() + DEADLINE_S
    while not os.path.exists(f"{out}/inputs.pkl") and time.monotonic() < end:
        time.sleep(0.1)
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    launches = _Launches()
    res = {"coords": dict(mesh.coords)}
    for case, (model, plan, opt, fresh, _) in RUNS.items():
        cfg = _port_cfg(model, plan, **opt)
        state, res[case], res[case, "launches"], res[case, "routes"] = _run(
            mesh, cfg, *inputs[model], fresh, launches)
        if case == "mixtral ep":
            res["ckpt"] = _checkpoint(mesh, cfg, state, f"{out}/grid.npz")
        del state
    _ORIG_COUNTS = moe._grid_counts
    moe._grid_counts = _planted_counts
    try:
        res["planted slots"] = _run(mesh, _port_cfg("mixtral e3", "fused"),
                                    *inputs["mixtral e3"], (True,), launches, routes=False)[1]
    finally:
        moe._grid_counts = _ORIG_COUNTS
    orig = moe._mean_prob
    moe._mean_prob = _planted_mean_prob
    try:
        res["planted lb"] = _run(mesh, _port_cfg("mixtral", "fused"), *inputs["mixtral"],
                                 (True,), launches, routes=False)[1]
    finally:
        moe._mean_prob = orig
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def _jax_router(jcfg):
    """f(params, batch) -> [group][MoE layer] (tokens, top_k) experts of the
    JAX forward of each of the k groups of ``batch`` at ``params`` (one
    compile)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.models import transformer as jt
    from torch_fast_jit import fast_jit

    calls, orig = [], jmoe._route

    def record(p, xf, cfg):
        out = orig(p, xf, cfg)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), out[1], ordered=True)
        return out

    fwd = fast_jit(lambda p, t: jt.forward(jcfg.model, jcfg.parallel, p, t, mode="train")[1])

    def routes(params, batch):
        tokens = np.asarray(batch["tokens"])
        out = []
        jmoe._route = record  # traced on the first call
        try:
            for g in tokens.reshape(jcfg.optimizer.k, -1, tokens.shape[-1]):
                jax.block_until_ready(fwd(params, jnp.asarray(g)))
                out.append(list(calls))
                calls.clear()
        finally:
            jmoe._route = orig
        return out

    return routes


def _jax_runs(inputs):
    """{JAX run: [(state, metrics, routes before the step) after each step]}
    of the single-device step, one compile per run and fresh flag."""
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtr
    from torch_fast_jit import fast_jit

    want = {}
    for run, (model, opt, fresh) in JAX_RUNS.items():
        jp, batches = inputs[model]
        jcfg = _jax_cfg(model, **opt)
        jstate = jtr.init_state(jcfg, params=jp)
        step = jtr.make_train_step(jcfg, log_gsnr=True)[0]
        jstep = {f: fast_jit(lambda s, b, f=f: step(s, b, f)) for f in set(fresh)}
        router = _jax_router(jcfg)
        want[run] = []
        for batch, with_stats in zip(batches, fresh):
            routes = router(jstate.params, batch)
            jstate, jm = jstep[with_stats](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            want[run].append((*jax.device_get((jstate, jm)), routes))
    return want


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """(every rank's results, the JAX runs, the tmp dir): the ranks run
    while the JAX side computes."""
    import jax

    from repro.data import lm_batches as j_lm_batches
    from repro.models import transformer as jt

    tmp = tmp_path_factory.mktemp("grid_moe")
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    inputs = {}
    for model in MODELS:
        jcfg = _jax_cfg(model)
        jp = jax.device_get(jt.init_params(jcfg.model, jax.random.PRNGKey(0)))
        stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
        inputs[model] = (jp, [next(stream) for _ in range(3)])
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump(inputs, f)
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
    want = _jax_runs(inputs)
    wait_ranks(ctx, DEADLINE_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r in range(WORLD):  # the checkpoint stays for its test
        os.remove(tmp / f"rank{r}.pt")
    return ranks, want, tmp


def _moe_close(tm, jm, what):
    for k in MOE_KEYS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=MOE_RTOL, err_msg=f"{k} {what}")


def _hold(jstate, jm, snap, step, data_axis=False):
    """One step against the JAX step: ``_compare``, or for the data-axis
    source its loss, norms and params (module docstring); the MoE
    readings."""
    import jax

    from repro_torch.core.layout import tree_paths
    from repro_torch.train.checkpoint import flat_to_numpy
    from test_torch_distributed import _as_state
    from test_torch_train import SCALARS, TOL, _compare

    tm = snap["metrics"]
    if data_axis:
        for k in SCALARS:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, err_msg=f"{k} @ {step}")
        got = flat_to_numpy(snap["params"], snap["layout"])
        for (path, a), (_, b) in zip(tree_paths(got), tree_paths(jax.device_get(jstate.params))):
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{path} @ {step}", **TOL)
    else:
        _compare(jstate, jm, _as_state(snap), tm, step)
    _moe_close(tm, jm, f"@ {step}")


@pytest.mark.parametrize("case", list(RUNS))
def test_moe_grid_steps_match_the_single_device_reference(grid_runs, case):
    ranks, want, _ = grid_runs
    fresh, run = RUNS[case][3:]
    snaps = ranks[0][case]
    assert len(snaps) == len(fresh)
    for i, snap in enumerate(snaps):
        jstate, jm, _ = want[run][i]
        _hold(jstate, jm, snap, i, data_axis="data_axis" in case)
        assert ("gsnr/mean" in snap["metrics"]) == fresh[i]
        for r, res in enumerate(ranks):
            assert res[case][i]["metrics"] == snap["metrics"], (case, r, i)


@pytest.mark.parametrize("case", list(RUNS))
def test_moe_grid_routes_as_the_reference(grid_runs, case):
    """Every routing decision of every group and MoE layer, the data ranks'
    rows in rank order, against the JAX forward's: no flip in f32; the model
    ranks of a data row route alike."""
    ranks, want, _ = grid_runs
    run = RUNS[case][4]
    m = GRID[1]
    decisions = 0
    for i, steps in enumerate(ranks[0][case, "routes"]):
        jroutes = want[run][i][2]
        for r, res in enumerate(ranks):  # each model rank as its data row's first
            row = ranks[r - r % m][case, "routes"][i]
            assert all(np.array_equal(a, b) for ga, gb in zip(res[case, "routes"][i], row)
                       for a, b in zip(ga, gb)), (case, i, r)
        for g, jg in enumerate(jroutes):
            if "data_axis" in case:  # group g is data rank g's rows
                port = ranks[g * m][case, "routes"][i][0]
            else:
                port = [np.concatenate([ranks[d * m][case, "routes"][i][g][layer]
                                        for d in range(GRID[0])])
                        for layer in range(len(jg))]
            assert len(port) == len(jg) == N_LAYERS, (case, i, g)
            for layer, (a, b) in enumerate(zip(port, jg)):
                assert a.shape == b.shape, (case, i, g, layer)
                flips = int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                assert flips == 0, (case, i, g, layer, flips)
                decisions += a.shape[0]
    assert decisions == 8 * 32 * N_LAYERS * len(RUNS[case][3])  # every token of every step


@pytest.mark.parametrize("case", list(RUNS))
def test_moe_launches_per_rank_follow_the_grid_table(grid_runs, case):
    ranks, _, _ = grid_runs
    plan, _, fresh = RUNS[case][1:4]
    for res in ranks:
        for i, counts in enumerate(res[case, "launches"]):
            assert counts == (want_launches(case, fresh[i]) if plan == "fused" else {}), \
                (case, i, counts)


@pytest.mark.parametrize("case", list(RUNS))
def test_moe_replicas_of_each_block_stay_bit_identical(grid_runs, case):
    from repro_torch.core.layout import ParamLayout
    from repro_torch.models.transformer import model_layout
    from repro_torch.sharding.placement import shard_shape
    from repro_torch.sharding.rules import Rules

    ranks, _, _ = grid_runs
    layout = model_layout(_port_cfg(RUNS[case][0], "fused").model)
    sizes = {"data": GRID[0], "model": GRID[1]}
    rules = Rules(mesh=types.SimpleNamespace(shape=sizes, axis_names=("data", "model")))
    specs = [rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)]
    local = ParamLayout(layout.paths, tuple(shard_shape(s, sp, sizes)
                                            for s, sp in zip(layout.shapes, specs)))
    for i in range(len(RUNS[case][3])):
        views = [local.leaf_views(res[case][i]["local"]) for res in ranks]
        for n, spec in enumerate(specs):
            for a in range(WORLD):
                for b in range(a + 1, WORLD):
                    ca, cb = ranks[a]["coords"], ranks[b]["coords"]
                    if all(ca[x] == cb[x] for x in spec.axes()):
                        assert torch.equal(views[a][n], views[b][n]), (case, i, n, a, b)


def test_planted_slots_without_the_data_ranks_offsets_fail(grid_runs):
    ranks, want, _ = grid_runs
    jstate, jm, _ = want["mixtral e3"][0]
    _hold(jstate, jm, ranks[0]["mixtral tp fallback"][0], 0)
    with pytest.raises(AssertionError):
        _hold(jstate, jm, ranks[0]["planted slots"][0], 0)


def _router_gap(jstate, snap):
    """The largest ||m_port - m_ref|| / ||m_ref|| over the router leaves."""
    import jax

    from repro_torch.core.layout import tree_paths
    from test_torch_train import _state_tree

    got = _state_tree(snap["opt_state"]["m"])
    ref = jax.device_get(jstate.opt_state["m"])
    return max(np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))
               for (path, a), (_, b) in zip(tree_paths(got), tree_paths(ref))
               if path.endswith("router"))


def test_planted_load_balance_sum_with_an_identity_backward_fails(grid_runs):
    """The router leaf's m past ``_compare``'s bound (STATE_REL) with the
    planted mean probability (the first run read 6.2e-3 against 2.2e-6
    without it, at the smoke's router_aux_weight 0.01)."""
    from test_torch_train import STATE_REL

    ranks, want, _ = grid_runs
    jstate, jm, _ = want["mixtral"][0]
    _hold(jstate, jm, ranks[0]["mixtral ep"][0], 0)
    assert _router_gap(jstate, ranks[0]["mixtral ep"][0]) <= STATE_REL
    assert _router_gap(jstate, ranks[0]["planted lb"][0]) > STATE_REL
    with pytest.raises(AssertionError):
        _hold(jstate, jm, ranks[0]["planted lb"][0], 0)


def test_moe_grid_checkpoint_restores_whole_and_into_the_grid(grid_runs):
    from repro_torch.core.layout import pad_mask
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore

    ranks, _, tmp = grid_runs
    assert all(res["ckpt"] for res in ranks)
    model, _, opt, fresh, _ = RUNS["mixtral ep"]
    last = ranks[0]["mixtral ep"][-1]
    back = restore(str(tmp / "grid.npz"), init_state(_port_cfg(model, "fused", **opt),
                                                     device="cpu"))
    assert torch.equal(back.params.data, last["params"])
    assert back.step == last["step"] == len(fresh)
    live = pad_mask(back.params.layout)
    for nm in "mvp":
        assert torch.equal(back.opt_state[nm].data[live], last["opt_state"][nm].data[live]), nm


def test_rank_split_loss_refuses_a_mixture_of_experts():
    """A one-card loss split over the data ranks' rows would route each
    block of rows alone (core/accumulate.py::rank_split_loss)."""
    from repro_torch.core.accumulate import rank_split_loss
    from repro_torch.train.loss import make_loss_fn

    for model in ("mixtral", "llama4"):
        with pytest.raises(ValueError, match="mixture of experts"):
            rank_split_loss(make_loss_fn(_port_cfg(model, "fused")), GRID[0])
    cfg = _port_cfg("mixtral", "fused")
    rank_split_loss(make_loss_fn(cfg.replace(model=dataclasses.replace(cfg.model, moe=None))),
                    GRID[0])


def test_moe_grid_form_with_the_experts_unsplit_is_the_one_card_moe():
    """``apply_moe_grid`` where the model axis splits neither the experts
    nor their d_ff ("rep": every expert whole on every rank, no collective)
    and each rank reads its own tokens (a payload sink set) computes the
    one-card ``apply_moe``, shared expert included: a placement stub, no
    ranks."""
    from repro_torch.models import moe
    from repro_torch.models.common import normal_init

    cfg = _port_cfg("llama4", "fused").model
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.moe)
    x = normal_init(gen, (2, 16, cfg.d_model))
    stub = types.SimpleNamespace(moe_mode="rep", m=2, j=1, sink=object(), mlp_tp=False)
    out, aux = moe.apply_moe_grid(p, x, cfg.act, cfg.moe, stub)
    want, want_aux = moe.apply_moe(p, x, cfg.act, cfg.moe)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for k in MOE_KEYS:
        torch.testing.assert_close(aux[k], want_aux[k], rtol=0, atol=0)
