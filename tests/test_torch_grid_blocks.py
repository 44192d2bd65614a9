"""Port parity of the RG-LRU, xLSTM and cross-attention blocks, whisper's
encoder and the image projection on a (data, model) grid of spawned gloo
ranks (sharding/placement.py, models/recurrent.py, models/attention.py,
models/transformer.py::forward_grid on a launch/mesh.py::GridMesh).

One group of four CPU ranks as a (2, 2) grid (``start_ranks``, one torch
thread each, a rendezvous file under the test's tmp dir) runs four smokes
in f32 compute, from the reference's init params (its numpy tree, each rank
keeping its blocks) on the reference's batches with seeded stub inputs
(``frames``, ``image``), k = 4 (global batch 8, seq 32: each data rank
takes one row of a group):

* (a) the recurrentgemma smoke (rec, rec, local with one kv head): the
  model axis splits the RG-LRU's channels (``rec_tp``) and the MLPs' d_ff;
  the local attention runs replicated (one kv head does not split).  Its
  config's VR-Adam on the fused plan, ``gsnr_refresh=2``: fresh, stale,
  fresh;
* (b) the xlstm smoke (mLSTM, sLSTM; d_ff = 0): both blocks replicated over
  the model axis, no MLP split; VR-Adam, fused, two fresh steps;
* (c) the whisper smoke (a 2-layer encoder over 16 frames; self- and
  cross-attention on the rank's heads); VR-Adam, fused, two fresh steps;
* (d) the vision smoke (attn, xattn over 16 image tokens through the
  replicated image projection); VR-LAMB on the reference plan, two fresh
  steps;
* (e) the recurrentgemma smoke by the vmap stats method, one step, against
  (a)'s first JAX step: ``torch.func`` through the RG-LRU's enters and
  products;
* (f) the whisper smoke with the data-axis source (k = D = 2), one step,
  against the JAX k = 2 microbatch step: its loss, norms and params (as
  tests/test_torch_grid_paths.py holds this source), the encoder's and the
  memory's gathers through the ``PayloadSink``.

Each step is held against the JAX ``make_train_step`` on one device with
tests/test_torch_train.py's ``_compare`` (loss, grad_norm, update_norm,
gsnr/*, params and m, v, p gathered whole).  Also:

* Every leaf block bit-identical on the ranks that hold it, after every step
  of every case, and each rank holding its ``held_elements`` share.
* Launches per rank and step on the fused plan (the kernel wrappers'
  calls): K1 twice and K2 once per attention call of a remat group and
  once each per encoder layer, per backward pass; the stats and update
  kernels as the dense grid's table.
* One block of each new kind on the grid against the same block on one
  card, without the optimizer: the RG-LRU block of (a) (its MLP takes the
  tensor-parallel path) and the cross-attention blocks of (c) and (d): the
  output, the input's and the memory's gradients and each leaf's gradient
  block (the data axis summing the two data ranks' rows), and the heads the
  cross-attention's K1 runs on: the rank's, against the memory's length.
* Three planted faults: ``a_log``'s gradient taken as the rank's own ("rep")
  instead of summed over the model axis, and the cross-attention's memory
  used without ``enter`` (no model-axis sum of its gradient: the encoder's
  m moves past ``_compare``'s bound), each of which must make ``_compare``
  fail; and the earlier ``mlp_tp``, vacuously true where d_ff == 0, with
  the last product row-split whatever the block: the xlstm step must not
  run (``xl_down``'s rows are cut to the model rank's half while its input
  is whole).
* The checkpoint: case (c)'s state saved from the grid restores whole into
  a one-card template, equal to the state gathered whole, and back into a
  grid template from another seed, each rank's blocks equal to its own;
  the state's params gathered to rank 0 alone equal the all-gather.

The rank function lives in this module and the ranks import it, so JAX is
imported inside the test functions only.  The ranks start first and wait
for their inputs after the single-block checks, which need none, while the
parent draws them with JAX; the JAX steps compile through
tests/torch_fast_jit.py.
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
K = 4
MODELS = {"recurrentgemma": "recurrentgemma-9b", "xlstm": "xlstm-1.3b",
          "whisper": "whisper-small", "vision": "llama-3.2-vision-11b"}
# case -> (model, plan, OptimizerConfig overrides, fresh flag of each step,
#          the JAX run it is held against); each runs its config's optimizer
RUNS = {
    "recurrentgemma": ("recurrentgemma", "fused", {"gsnr_refresh": 2}, (True, False, True),
                       "recurrentgemma"),
    "xlstm": ("xlstm", "fused", {}, (True, True), "xlstm"),
    "whisper": ("whisper", "fused", {}, (True, True), "whisper"),
    "vision": ("vision", "reference", {}, (True, True), "vision"),
    "recurrentgemma vmap": ("recurrentgemma", "fused", {"stats_method": "vmap"}, (True,),
                            "recurrentgemma"),
    "whisper data_axis": ("whisper", "fused", {"name": "vr_lamb", "gsnr_source": "data_axis"},
                          (True,), "whisper k2"),
}
# JAX run -> (model, OptimizerConfig overrides, fresh flags)
JAX_RUNS = {
    "recurrentgemma": ("recurrentgemma", {"gsnr_refresh": 2}, (True, False, True)),
    "xlstm": ("xlstm", {}, (True, True)),
    "whisper": ("whisper", {}, (True, True)),
    "vision": ("vision", {}, (True, True)),
    "whisper k2": ("whisper", {"name": "vr_lamb", "k": 2}, (True,)),
}
# the JAX runs whose own step, from params one f32 ulp up, moves a scalar of
# ``_compare`` past its bound: the xlstm smoke's first grad_norm by 3.3e-5
# (the mLSTM's exponential gates; the port on one card reads 1.6e-5 from
# it).  Such a scalar is held within the witness's gap instead (``_hold``).
WITNESSED = ("xlstm",)
# attention calls of one microbatch's pass: (in the remat groups, encoder layers)
ATTN_CALLS = {"recurrentgemma": (1, 0), "xlstm": (0, 0), "whisper": (4, 2), "vision": (3, 0)}
# (model, the block's position in the group) of the single-block checks
BLOCKS = {"rec": ("recurrentgemma", 0), "whisper xattn": ("whisper", 0),
          "vision xattn": ("vision", 1)}
# a block on the grid against one card: f32 sums of a few hundred terms in
# another order, within 1e-5 of the tensor's largest element


def _block_tol(want):
    return dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def want_launches(case, fresh):
    """The launches of one rank's fused step: K1 twice and K2 once per
    attention call in a remat group (forward, recompute, backward), once
    each per encoder layer (no remat), per backward pass (the vmap method:
    one pass, no remat); the stats and update kernels as the dense grid's
    table (tests/test_torch_grid_paths.py): VR-Adam's K13 and K15, VR-LAMB's
    K13, K16 and ``trust_apply``."""
    model, _, opt = RUNS[case][:3]
    vmap = opt.get("stats_method") == "vmap"
    data_axis = opt.get("gsnr_source") == "data_axis" and fresh
    passes = 1 if (data_axis or vmap) else K
    grouped, encoder = ATTN_CALLS[model]
    want = {"K1": ((1 if vmap else 2) * grouped + encoder) * passes,
            "K2": (grouped + encoder) * passes}
    want = {k: n for k, n in want.items() if n}
    if vmap:
        want["K10"] = 1
    elif data_axis:
        want["K11"] = 1
    elif fresh:
        want.update(K3=K, K4=1)
    else:
        want["K9"] = K
    if fresh:
        want.update(K13=1, **{"K16" if opt.get("name") == "vr_lamb" else "K15": 1})
    if opt.get("name") == "vr_lamb":
        want["trust_apply"] = 1
    return want


def _port_cfg(model, plan, **opt):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    cfg = get_smoke(MODELS[model])
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    return cfg.replace(
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=bk),
        optimizer=dataclasses.replace(cfg.optimizer, **{"k": K, **opt}))


def _jax_cfg(model, **opt):
    from repro_torch.configs import get_smoke
    from test_torch_train import _cfgs

    opt = {"name": get_smoke(MODELS[model]).optimizer.name, "k": K, **opt}
    return _cfgs(MODELS[model], "reference", opt.pop("name"), **opt)[0]


def _stub_inputs(m, b, seed):
    """The seeded stub inputs of a model (numpy f32): whisper's frames or
    the vision model's image embeddings."""
    rs = np.random.default_rng(seed)
    if m.encoder is not None:
        return {"frames": rs.standard_normal((b, m.encoder.n_frames, m.d_model), dtype=np.float32)}
    if m.n_image_tokens:
        return {"image": rs.standard_normal((b, m.n_image_tokens, m.d_model), dtype=np.float32)}
    return {}


def _run(mesh, cfg, jparams, batches, fresh, launches):
    """(state, a snapshot per step, launches per step).  Only rank 0 keeps
    the whole params and state it gathered; the others keep their metrics
    and blocks."""
    from test_torch_grid import _snapshot

    from repro_torch.train import init_state, make_train_step

    state = init_state(cfg, params=jparams, device="cpu", mesh=mesh)
    step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh)[0]
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


def _held(state):
    sh = state.params.shard
    return {"held": sh.held, "specs": sh.specs}


def _block_check(mesh, model, pos):
    """One block of ``model`` at group position ``pos`` on the grid and on
    one card (fused plan, seeded weights, the data ranks taking one row
    each of a batch of two): the rank's output rows, its input's and
    memory's gradient rows, its leaf blocks' gradients, beside the one-card
    values; and the (q, k) shapes of the cross-attention's K1 call."""
    from repro_torch.core.layout import nest_paths, tree_paths
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as tt
    from repro_torch.sharding.placement import shard_params
    from repro_torch.sharding.rules import Spec
    from repro_torch.train.trainer import grid_plan

    cfg = _port_cfg(model, "fused")
    m, pc = cfg.model, cfg.parallel
    kind = m.block_pattern[pos]
    pl, _ = grid_plan(cfg, mesh)
    gen = torch.Generator().manual_seed(7)
    block = tt.init_params(m, gen)["groups"][0][f"pos{pos}"]
    b, s, d = 2, 32, m.d_model
    x = torch.randn(b, s, d, generator=gen)
    dy = torch.randn(b, s, d, generator=gen)
    memory = torch.randn(b, tt.memory_len(m), d, generator=gen) if kind == "xattn" else None
    kw = dict(q_pos=tt._q_pos(x[..., 0], None), cache=None, mode="train", cache_len=0,
              implicit_layout=True, q_seg=None, seg_base=None)

    def run(p, rows, tp):
        xx = x[rows].clone().requires_grad_(True)
        mem = None if memory is None else memory[rows].clone().requires_grad_(True)
        out, _, _ = tt._block_apply(m, pc, kind, p, xx, tp=tp, memory=mem,
                                    **{**kw, "q_pos": kw["q_pos"][rows]})
        (out * dy[rows]).sum().backward()
        return out.detach(), xx.grad, None if mem is None else mem.grad

    whole = {path: t.clone().requires_grad_(True) for path, t in tree_paths(block)}
    one = run(nest_paths(whole), slice(None), None)
    i = mesh.coords["data"]
    rows = slice(i, i + 1)
    prefix = f"groups/pos{pos}/" if pl.stacked else f"groups/0/pos{pos}/"
    dims = 1 if pl.stacked else 0
    specs = {path: Spec(*pl.specs[prefix + path][dims:]) for path in whole}
    local = {path: shard_params(t.detach(), specs[path], mesh).requires_grad_(True)
             for path, t in whole.items()}
    calls, orig = [], kops.flash_attention

    def record(q, k, *a, **kwa):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, *a, **kwa)

    kops.flash_attention = record
    try:
        grid = run(nest_paths({path: pl.use(t, prefix + path, dims) for path, t in local.items()}),
                   rows, pl)
    finally:
        kops.flash_attention = orig
    want_grads = {path: shard_params(whole[path].grad, specs[path], mesh) for path in whole}
    return {"grid": grid, "one": tuple(None if t is None else t[rows] for t in one),
            "grads": {path: (t.grad, want_grads[path]) for path, t in local.items()},
            "k1": calls, "flags": (pl.attn_tp, pl.xattn_tp, pl.mlp_tp, pl.rec_tp)}


def _planted_a_log_role(self, path):
    """Placement.role with a_log "rep": its gradient the rank's own
    partial instead of the model axis's sum."""
    return "rep" if path.endswith("/a_log") else _ORIG_ROLE(self, path)


class _MemoryNotEntered:
    """A placement whose ``enter`` of the cross-attention's memory (the
    tensor ``memory_len`` rows long) is a plain f32 cast: no model-axis sum
    of the memory's gradient."""

    def __init__(self, tp, mem_len):
        self.tp, self.mem_len = tp, mem_len

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def enter(self, t):
        return t.float() if t.shape[1] == self.mem_len else self.tp.enter(t)


def _planted_attention(p, x, *a, memory=None, tp=None, **kw):
    if memory is not None and tp is not None:
        tp = _MemoryNotEntered(tp, memory.shape[1])
    return _ORIG_ATTENTION(p, x, *a, memory=memory, tp=tp, **kw)


def _parent_block_apply(cfg, pcfg, kind, p, x, tp=None, **kw):
    """models/transformer.py::_block_apply as the grid first had it: the
    last product row-split wherever ``mlp_tp`` is set."""
    from repro_torch.models import transformer as tt
    from repro_torch.sharding.rules import constrain

    x, hidden, c, aux = tt._block_body(cfg, pcfg, kind, p, x, tp=tp, **kw)
    if hidden is not None:
        w = tt._leaf(p, tt.last_product(cfg, kind))
        if tp is not None and tp.mlp_tp:
            x = x + tp.row_product(hidden, w)
        else:
            x = x + hidden @ w.to(x.dtype)
    return constrain(x, ("batch", None, None)), c, aux


_ORIG_ROLE = _ORIG_ATTENTION = None


def _planted_runs(mesh, inputs, launches):
    global _ORIG_ROLE, _ORIG_ATTENTION
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import placement as plm

    out = {}
    _ORIG_ROLE = plm.Placement.role
    plm.Placement.role = _planted_a_log_role
    try:
        out["planted a_log"] = _run(mesh, _port_cfg("recurrentgemma", "fused"),
                                    *inputs["recurrentgemma"][:1],
                                    inputs["recurrentgemma"][1][:1], (True,), launches)[1]
    finally:
        plm.Placement.role = _ORIG_ROLE
    _ORIG_ATTENTION = attn_mod.attention
    attn_mod.attention = _planted_attention
    try:
        out["planted memory"] = _run(mesh, _port_cfg("whisper", "fused"), inputs["whisper"][0],
                                     inputs["whisper"][1][:1], (True,), launches)[1]
    finally:
        attn_mod.attention = _ORIG_ATTENTION
    orig_init, orig_apply = plm.Placement.__init__, tt._block_apply

    def parent_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.mlp_tp = self.m > 1  # the earlier rule here: 0 % M == 0, and no wi leaf to check

    plm.Placement.__init__, tt._block_apply = parent_init, _parent_block_apply
    try:
        out["planted mlp_tp"] = _run(mesh, _port_cfg("xlstm", "fused"), inputs["xlstm"][0],
                                     inputs["xlstm"][1][:1], (True,), launches)[1]
    except RuntimeError as e:  # every rank fails alike, in the first layer's forward
        out["planted mlp_tp"] = str(e)
    finally:
        plm.Placement.__init__, tt._block_apply = orig_init, orig_apply
    return out


def _rank(rank, init, out):
    from test_torch_grid_paths import _checkpoint, _Launches

    from repro_torch.launch.mesh import init_grid_mesh

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    mesh = init_grid_mesh("gloo", *GRID, "cpu", init_method=init, rank=rank)
    res = {"coords": dict(mesh.coords)}
    for name, (model, pos) in BLOCKS.items():  # while the parent draws the inputs
        res["block", name] = _block_check(mesh, model, pos)
    end = time.monotonic() + DEADLINE_S
    while not os.path.exists(f"{out}/inputs.pkl") and time.monotonic() < end:
        time.sleep(0.1)
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    launches = _Launches()
    for case, (model, plan, opt, fresh, _) in RUNS.items():
        cfg = _port_cfg(model, plan, **opt)
        state, res[case], res[case, "launches"] = _run(mesh, cfg, *inputs[model], fresh,
                                                       launches)
        res[case, "held"] = _held(state)
        if case == "whisper":
            res["ckpt"] = _checkpoint(mesh, cfg, state, f"{out}/grid.npz")
            to0 = state.params.shard.gather(state.params.data, dst=0)
            whole = state.params.gather()
            res["gather to 0"] = (None if to0 is None else torch.equal(to0, whole),
                                  to0 is None)
        del state
    res.update(_planted_runs(mesh, inputs, launches))
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def _jax_runs(inputs):
    """{JAX run: [(state, metrics, the witness's metrics or None) after each
    step]} of the single-device step, one compile per run and fresh flag;
    the witness (``WITNESSED``) is the same run from params one f32 ulp
    up."""
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtr
    from torch_fast_jit import fast_jit

    want = {}
    for run, (model, opt, fresh) in JAX_RUNS.items():
        jp, batches = inputs[model]
        jcfg = _jax_cfg(model, **opt)
        jstate = jtr.init_state(jcfg, params=jp)
        wstate = None
        if run in WITNESSED:
            wstate = jtr.init_state(jcfg, params=jax.tree_util.tree_map(
                lambda x: np.nextafter(x, np.float32(np.inf)), jp))
        step = jtr.make_train_step(jcfg, log_gsnr=True)[0]
        jstep = {f: fast_jit(lambda s, b, f=f: step(s, b, f)) for f in set(fresh)}
        want[run] = []
        for batch, with_stats in zip(batches, fresh):
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            jstate, jm = jstep[with_stats](jstate, batch)
            wm = None
            if wstate is not None:
                wstate, wm = jstep[with_stats](wstate, batch)
            want[run].append(jax.device_get((jstate, jm, wm)))
    return want


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """(every rank's results, the JAX runs, the tmp dir): the ranks run
    while the JAX side computes."""
    import jax

    from repro.data import lm_batches as j_lm_batches
    from repro.models import transformer as jt
    from torch_fast_jit import fast_jit

    tmp = tmp_path_factory.mktemp("grid_blocks")
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    inputs = {}
    for i, model in enumerate(MODELS):
        jcfg = _jax_cfg(model)
        init = fast_jit(lambda key, m=jcfg.model: jt.init_params(m, key))
        jp = jax.device_get(init(jax.random.PRNGKey(0)))
        stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
        batches = [{**next(stream), **_stub_inputs(jcfg.model, jcfg.global_batch, 10 * i + n)}
                   for n in range(3)]
        inputs[model] = (jp, batches)
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump(inputs, f)
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
    want = _jax_runs(inputs)
    wait_ranks(ctx, DEADLINE_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r in range(WORLD):  # the checkpoint stays for its test
        os.remove(tmp / f"rank{r}.pt")
    return ranks, want, tmp


def _hold(jstate, jm, snap, step, data_axis=False, wm=None):
    """One step against the JAX step: ``_compare``, or for the data-axis
    source its loss, norms and params (tests/test_torch_grid_paths.py's
    docstring: k = 2's conditioning).  With the witness's metrics ``wm``,
    a scalar the witness moves past ``_compare``'s rtol is held within the
    witness's gap, and ``_compare`` holds the rest."""
    import jax

    from repro_torch.core.layout import tree_paths
    from repro_torch.train.checkpoint import flat_to_numpy
    from test_torch_distributed import _as_state
    from test_torch_train import SCALARS, TOL, _compare

    tm = snap["metrics"]
    if not data_axis:
        gap = lambda m, k: abs(float(m[k]) - float(jm[k])) / abs(float(jm[k]))
        spread = {k: gap(wm, k) for k in SCALARS if wm is not None and gap(wm, k) > 1e-5}
        for k, bound in spread.items():
            assert gap(tm, k) <= bound, (k, step, gap(tm, k), bound)
        _compare(jstate, {**jm, **{k: tm[k] for k in spread}}, _as_state(snap), tm, step)
        return
    for k in SCALARS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, err_msg=f"{k} @ {step}")
    got = flat_to_numpy(snap["params"], snap["layout"])
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(jax.device_get(jstate.params))):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"{path} @ {step}", **TOL)


@pytest.mark.parametrize("case", list(RUNS))
def test_block_grid_steps_match_the_single_device_reference(grid_runs, case):
    ranks, want, _ = grid_runs
    fresh, run = RUNS[case][3:]
    snaps = ranks[0][case]
    assert len(snaps) == len(fresh)
    for i, snap in enumerate(snaps):
        jstate, jm, wm = want[run][i]
        _hold(jstate, jm, snap, i, data_axis="data_axis" in case, wm=wm)
        assert ("gsnr/mean" in snap["metrics"]) == fresh[i]
        for r, res in enumerate(ranks):
            assert res[case][i]["metrics"] == snap["metrics"], (case, r, i)


@pytest.mark.parametrize("case", list(RUNS))
def test_block_launches_per_rank_follow_the_grid_table(grid_runs, case):
    ranks, _, _ = grid_runs
    plan, _, fresh = RUNS[case][1:4]
    for res in ranks:
        for i, counts in enumerate(res[case, "launches"]):
            assert counts == (want_launches(case, fresh[i]) if plan == "fused" else {}), \
                (case, i, counts)


@pytest.mark.parametrize("case", list(RUNS))
def test_block_replicas_agree_and_each_rank_holds_its_share(grid_runs, case):
    from repro_torch.core.layout import ParamLayout
    from repro_torch.models.transformer import model_layout
    from repro_torch.sharding.placement import held_elements, shard_shape
    from repro_torch.sharding.rules import Rules

    ranks, _, _ = grid_runs
    layout = model_layout(_port_cfg(RUNS[case][0], "fused").model)
    sizes = {"data": GRID[0], "model": GRID[1]}
    rules = Rules(mesh=types.SimpleNamespace(shape=sizes, axis_names=("data", "model")))
    specs = [rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)]
    shapes = dict(zip(layout.paths, layout.shapes))
    want_held = held_elements(shapes, dict(zip(layout.paths, specs)), sizes)
    assert 0.24 * sum(layout.sizes) < want_held < 0.27 * sum(layout.sizes)
    local = ParamLayout(layout.paths, tuple(shard_shape(s, sp, sizes)
                                            for s, sp in zip(layout.shapes, specs)))
    for res in ranks:
        assert res[case, "held"]["held"] == want_held
        assert tuple(res[case, "held"]["specs"]) == tuple(specs)
    for i in range(len(RUNS[case][3])):
        views = [local.leaf_views(res[case][i]["local"]) for res in ranks]
        for n, spec in enumerate(specs):
            for a in range(WORLD):
                for b in range(a + 1, WORLD):
                    ca, cb = ranks[a]["coords"], ranks[b]["coords"]
                    if all(ca[x] == cb[x] for x in spec.axes()):
                        assert torch.equal(views[a][n], views[b][n]), (case, i, n, a, b)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_one_block_on_the_grid_is_the_one_card_block(grid_runs, block):
    """The RG-LRU block with its MLP on the tensor-parallel path, and the
    cross-attention blocks with their own head counts: each rank's output,
    input and memory gradient rows and leaf gradient blocks against one
    card's, and the cross-attention's K1 on the rank's heads (the kv heads
    / M) over the memory's length."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import memory_len

    ranks, _, _ = grid_runs
    model, pos = BLOCKS[block]
    m = get_smoke(MODELS[model]).model
    for res in ranks:
        got = res["block", block]
        attn_tp, xattn_tp, mlp_tp, rec_tp = got["flags"]
        assert mlp_tp and (rec_tp if block == "rec" else xattn_tp), got["flags"]
        for what, a, b in zip(("output", "input grad", "memory grad"), got["grid"], got["one"]):
            assert (a is None) == (b is None), what
            if a is not None:
                torch.testing.assert_close(a, b, **_block_tol(b),
                                           msg=lambda e: f"{block} {what}: {e}")
        for path, (a, b) in got["grads"].items():
            torch.testing.assert_close(a, b, **_block_tol(b),
                                       msg=lambda e: f"{block} {path}: {e}")
        if block != "rec":
            cross = [c for c in got["k1"] if c[1][1] == memory_len(m)]
            heads = m.n_kv_heads // GRID[1]
            assert len(cross) == 1 and cross[0][0][2] == cross[0][1][2] == heads, got["k1"]


def test_planted_a_log_gradient_of_the_rank_alone_fails(grid_runs):
    ranks, want, _ = grid_runs
    jstate, jm, _ = want["recurrentgemma"][0]
    _hold(jstate, jm, ranks[0]["recurrentgemma"][0], 0)
    with pytest.raises(AssertionError):
        _hold(jstate, jm, ranks[0]["planted a_log"][0], 0)


def _encoder_m_gap(jstate, snap):
    """The largest ||m_port - m_ref|| / ||m_ref|| over the encoder's
    leaves."""
    import jax

    from repro_torch.core.layout import tree_paths
    from test_torch_train import _state_tree

    got = _state_tree(snap["opt_state"]["m"])
    ref = jax.device_get(jstate.opt_state["m"])
    return max(np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))
               for (path, a), (_, b) in zip(tree_paths(got), tree_paths(ref))
               if path.startswith("encoder/"))


def test_planted_memory_without_enter_fails(grid_runs):
    """The cross-attention's memory not entered: its gradient is the rank's
    heads' part only, and the encoder's m moves past ``_compare``'s bound
    (STATE_REL)."""
    from test_torch_train import STATE_REL

    ranks, want, _ = grid_runs
    jstate, jm, _ = want["whisper"][0]
    _hold(jstate, jm, ranks[0]["whisper"][0], 0)
    assert _encoder_m_gap(jstate, ranks[0]["whisper"][0]) <= STATE_REL
    assert _encoder_m_gap(jstate, ranks[0]["planted memory"][0]) > STATE_REL
    with pytest.raises(AssertionError):
        _hold(jstate, jm, ranks[0]["planted memory"][0], 0)


def test_planted_row_split_of_the_xlstm_down_projection_fails(grid_runs):
    """The earlier ``mlp_tp`` (true where d_ff == 0) with the last product
    row-split whatever the block: ``xl_down``'s rows are cut to the model
    rank's half while the mLSTM's hidden is whole, and the step fails on
    every rank."""
    ranks, _, _ = grid_runs
    for res in ranks:
        assert isinstance(res["planted mlp_tp"], str), res["planted mlp_tp"]
        assert "mat1 and mat2 shapes cannot be multiplied" in res["planted mlp_tp"]


def test_mlp_tp_needs_an_mlp():
    """No ranks: the xlstm smoke (d_ff == 0, no ``wi`` leaf) splits no d_ff
    on (2, 2), where ``0 % M == 0`` and a check over no ``wi`` leaves held
    vacuously; the recurrentgemma, whisper and vision smokes split theirs,
    and the RG-LRU's channels (recurrentgemma) and the cross-attention's
    heads (whisper, vision) too."""
    from repro_torch.models.transformer import model_layout
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.rules import MeshShape, Rules

    rules = Rules(mesh=MeshShape((2, 2), ("data", "model")))
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, coords={"data": 0, "model": 1},
                                 axis_names=("data", "model"))
    flags = {}
    for model in MODELS:
        m = _port_cfg(model, "fused").model
        layout = model_layout(m)
        pl = Placement(m, rules, mesh, {p: rules.leaf_pspec(p, s) for p, s in
                                        zip(layout.paths, layout.shapes)},
                       dict(zip(layout.paths, layout.shapes)))
        flags[model] = (pl.mlp_tp, pl.rec_tp, pl.attn_tp, pl.xattn_tp)
    assert flags == {"recurrentgemma": (True, True, False, False),
                     "xlstm": (False, False, False, False),
                     "whisper": (True, False, True, True),
                     "vision": (True, False, True, True)}, flags


def test_gather_to_one_rank_is_the_all_gather_there(grid_runs):
    """``GridShard.gather(dst=0)`` (one gather; phase 10d's holds take the
    whole buffers this way): rank 0 gets the all-gathered buffer, the
    others None."""
    ranks, _, _ = grid_runs
    assert ranks[0]["gather to 0"] == (True, False)
    assert all(res["gather to 0"] == (None, True) for res in ranks[1:])


def test_block_grid_checkpoint_restores_whole_and_into_the_grid(grid_runs):
    from repro_torch.core.layout import pad_mask
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore

    ranks, _, tmp = grid_runs
    assert all(res["ckpt"] for res in ranks)
    model, plan, opt, fresh, _ = RUNS["whisper"]
    last = ranks[0]["whisper"][-1]
    back = restore(str(tmp / "grid.npz"), init_state(_port_cfg(model, plan, **opt),
                                                     device="cpu"))
    assert torch.equal(back.params.data, last["params"])
    assert back.step == last["step"] == len(fresh)
    live = pad_mask(back.params.layout)
    for nm in "mvp":
        assert torch.equal(back.opt_state[nm].data[live], last["opt_state"][nm].data[live]), nm
