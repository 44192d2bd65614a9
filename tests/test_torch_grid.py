"""Port parity of the weights' FSDP+TP sharding on a (data, model) grid of
spawned gloo ranks (launch/mesh.py::GridMesh, sharding/placement.py,
models/transformer.py::forward_grid, backend.py::GridSpmd).

One group of four CPU ranks as a (2, 2) grid (``start_ranks``, one torch
thread each, a rendezvous file under the test's tmp dir) runs:

* The grid step: the bert-large smoke (bidirectional, LayerNorm, GELU, tied
  embedding) and the internlm2 smoke (causal, RoPE, SwiGLU, untied head) in
  f32 compute on both plans, VR-LAMB at k = 4 with ``gsnr_refresh=2``
  (internlm2 at its config's VR-LAMB lr, ``_opt``): fresh, stale, fresh, from the reference's init params (its numpy tree,
  each rank keeping its blocks) on the reference's batches.  Each step is
  held against the JAX ``make_train_step`` on one device with
  tests/test_torch_train.py's ``_compare`` (loss, grad_norm, update_norm,
  gsnr/*, params and m, v, p, gathered whole).  Every leaf block must be
  bit-identical on the ranks that hold it (a leaf replicated over an axis
  is held whole by each of its ranks); each rank holds exactly its spec
  block sizes (about a quarter of the params), and its optimizer state
  the same local layout.
* A planted x M double count across the model axis: the replicated
  leaves' gathers summing over the model axis (as if the model ranks had
  computed disjoint parts) instead of taking the rank's own block.  The
  norms' gradients then come out M = 2 times too large, and ``_compare``
  of the first step must fail.
* The vocab-parallel cross-entropy: the rank's vocab columns of seeded
  logits through ``cross_entropy`` and ``document_cross_entropy`` with the
  bert smoke's placement, against the plain loss on the whole logits; the
  loss within rtol 1e-6 and each rank's logit gradient within atol 1e-7 of
  its columns of the whole gradient.
* The refusals on the grid: what is not ported yet raises
  NotImplementedError naming ROADMAP A9.4b: cross-attention in decode mode,
  the xlstm smoke's mLSTM in prefill mode and the ContinuousEngine on a
  rank's GridParams.  Every optimizer, source and stats method trains there
  (tests/test_torch_grid_paths.py), and so do the MoE configs
  (tests/test_torch_grid_moe.py) and the RG-LRU, xLSTM and cross-attention
  blocks (tests/test_torch_grid_blocks.py); the attention, RG-LRU and MoE
  blocks serve there (tests/test_torch_grid_serve.py).
* The checkpoint: the fused bert run's state saved from the grid (gathered,
  rank 0 writes) restores whole into a one-card template, equal
  (``torch.equal``, on the leaf elements) to the state gathered whole, and
  back into a grid template from another seed, each rank's blocks equal to
  its own.

The rank function lives in this module and the ranks import it, so JAX is
imported inside the test functions only.  The ranks start first and wait
for their inputs, which the parent draws with JAX meanwhile; the JAX steps
compile through tests/torch_fast_jit.py.
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
ARCHS = ("bert-large", "internlm2-1.8b")
PLANS = ("fused", "reference")
FRESH = (True, False, True)
OPT = dict(k=4, gsnr_refresh=2)
# what still raises on the grid (ROADMAP A9.4b): serving cross-attention
# and the xLSTM cells, and the ContinuousEngine; every block kind,
# optimizer, source and stats method trains there
REFUSED = ("cross-attention decode", "mlstm prefill", "continuous engine")


def _opt(arch):
    """The VR-LAMB runs' OptimizerConfig overrides.  The internlm2 smoke's
    own lr (0.05) is its VR-SGD lr; VR-LAMB takes the config's, 2e-3.  At
    0.05 the fresh step after the stale one moves a few embedding elements
    whose GSNR ratio sits at the clip floor across it, in the one-card port
    as on the grid (tests/test_torch_train.py's docstring: ill-conditioned
    in the reference itself), past ``_compare``'s params tolerance."""
    from repro_torch.configs import get_config

    lr = {"internlm2-1.8b": get_config("internlm2-1.8b").optimizer.lr}.get(arch)
    return {**OPT, **({} if lr is None else {"lr": lr})}


def _port_cfg(arch, plan, **opt):
    from repro_torch.backend import Backend
    from repro_torch.configs import get_smoke

    cfg = get_smoke(arch)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    return cfg.replace(
        parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32", backend=bk),
        optimizer=dataclasses.replace(cfg.optimizer, **{"name": "vr_lamb", **_opt(arch), **opt}))


def _whole(x, shard):
    """A FlatBuffer of the rank's blocks, or a tree of them, gathered whole."""
    from repro_torch.core.layout import FlatBuffer, is_flat

    local = x.data if is_flat(x) else shard.local_layout.pack(x)
    return FlatBuffer(shard.gather(local), shard.layout)


def _snapshot(state, metrics):
    shard = state.params.shard
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": state.params.gather(), "layout": state.params.layout,
            "local": state.params.data.clone(), "step": state.step,
            "opt_state": {k: _whole(v, shard) if k in "mvp" else v
                          for k, v in state.opt_state.items()}}


def _run(mesh, cfg, jparams, batches, fresh=FRESH):
    from repro_torch.core.layout import is_flat, tree_leaves
    from repro_torch.train import init_state, make_train_step

    state = init_state(cfg, params=jparams, device="cpu", mesh=mesh)
    step = make_train_step(cfg, log_gsnr=True, device="cpu", mesh=mesh)[0]
    snaps = []
    for batch, with_stats in zip(batches, fresh):
        state, metrics = step(state, batch, with_stats)
        snaps.append(_snapshot(state, metrics))
    sh = state.params.shard
    held = {"held": sh.held, "rows": sh.rows, "specs": sh.specs,
            "state": {k: tuple(v.data.shape) if is_flat(v) else
                      sum(x.numel() for x in tree_leaves(v))
                      for k, v in state.opt_state.items() if k in "mvp"}}
    return state, snaps, held


def _planted_use(self, x, path, dims=0):
    """Placement.use with the replicated leaves' gathers summing over the
    model axis: a x M double count of their gradients."""
    from repro_torch.sharding import placement as plm
    from repro_torch.sharding.rules import Spec

    if self.role(path) == "rep" and self.m > 1:
        spec = Spec(*self.specs[path][dims:])
        return plm.gather(x, spec, self.mesh, spec.axes(), same=())
    return _ORIG_USE(self, x, path, dims)


_ORIG_USE = None


def _ce_run(mesh, ce_inputs):
    """The rank's vocab columns through the two cross-entropies: their
    values and logit gradients."""
    from repro_torch.train.loss import cross_entropy, document_cross_entropy
    from repro_torch.train.trainer import grid_plan

    pl, _ = grid_plan(_port_cfg("bert-large", "fused"), mesh)
    logits, targets, mask, segments = (torch.as_tensor(x) for x in ce_inputs)
    v = logits.shape[-1] // pl.m
    out = {"vocab_tp": pl.vocab_tp}
    for name, fn in (("token", lambda z: cross_entropy(z, targets, mask, placement=pl)),
                     ("document", lambda z: document_cross_entropy(z, targets, segments, mask,
                                                                   placement=pl))):
        z = logits[..., pl.j * v:(pl.j + 1) * v].clone().requires_grad_(True)
        loss = fn(z)
        loss.backward()
        out[name] = (float(loss.detach()), z.grad.clone(), pl.j)
    return out


def _refusals(mesh):
    from repro_torch.models.attention import attention
    from repro_torch.models.transformer import forward_grid
    from repro_torch.serve import ContinuousEngine
    from repro_torch.train.trainer import grid_params, grid_plan

    cfg = _port_cfg("bert-large", "fused")
    m = cfg.model
    pl, _ = grid_plan(cfg, mesh)
    blocks = pl.mesh.shape["model"]
    x = torch.zeros(1, 4, m.d_model)
    pos = torch.arange(4, dtype=torch.int32)[None]
    attn = {n: torch.zeros(m.d_model, m.d_model // blocks) for n in ("wq", "wk", "wv")}
    attn["wo"] = torch.zeros(m.d_model, m.d_model)
    xl_cfg = _port_cfg("xlstm-1.3b", "fused")
    xl_pl, _ = grid_plan(xl_cfg, mesh)
    calls = {
        "cross-attention decode": lambda: attention(
            attn, x[:, :1], n_heads=m.n_heads // blocks, n_kv_heads=m.n_kv_heads // blocks,
            head_dim=m.resolved_head_dim, q_pos=pos[:, :1], memory=x, mode="decode", tp=pl),
        "mlstm prefill": lambda: forward_grid(
            xl_cfg.model, xl_cfg.parallel, {"whole": {}, "groups": []},
            torch.zeros(1, 4, dtype=torch.int64), xl_pl, mode="prefill", cache_len=8),
        "continuous engine": lambda: ContinuousEngine(
            cfg, grid_params(cfg, None, mesh, "cpu")[0], device="cpu"),
    }
    out = {}
    for case in REFUSED:
        try:
            calls[case]()
            out[case] = None
        except NotImplementedError as e:
            out[case] = str(e)
    return out


def _checkpoint(mesh, cfg, state, path):
    """Save the grid state; restore it into a grid template from another
    seed: whether every rank's blocks came back equal."""
    from repro_torch.core.layout import pad_mask
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore, save

    save(path, state, mesh=mesh)
    back = restore(path, init_state(cfg.replace(seed=1), device="cpu", mesh=mesh))
    live = pad_mask(state.params.local_layout)
    ok = torch.equal(back.params.data, state.params.data) and back.step == state.step
    for nm in "mvp":
        a, b = back.opt_state[nm], state.opt_state[nm]
        ok = ok and a.shard.specs == b.shard.specs and torch.equal(a.data[live], b.data[live])
    return ok


def _rank(rank, init, out):
    global _ORIG_USE
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.sharding import placement as plm

    torch.set_num_threads(1)  # smoke-sized work on a shared machine
    mesh = init_grid_mesh("gloo", *GRID, "cpu", init_method=init, rank=rank)
    # the parent starts the ranks first and writes the inputs while they
    # start (an atomic rename): wait for them
    end = time.monotonic() + DEADLINE_S
    while not os.path.exists(f"{out}/inputs.pkl") and time.monotonic() < end:
        time.sleep(0.1)
    with open(f"{out}/inputs.pkl", "rb") as f:
        inputs, ce_inputs = pickle.load(f)
    res = {"coords": dict(mesh.coords)}
    for arch in ARCHS:
        jparams, batches = inputs[arch]
        for plan in PLANS:
            cfg = _port_cfg(arch, plan)
            state, res[arch, plan], res[arch, plan, "held"] = _run(mesh, cfg, jparams, batches)
            if arch == "bert-large" and plan == "fused":
                res["ckpt"] = _checkpoint(mesh, cfg, state, f"{out}/grid.npz")
            del state
    _ORIG_USE = plm.Placement.use
    plm.Placement.use = _planted_use
    try:
        jparams, batches = inputs["bert-large"]
        res["planted"] = _run(mesh, _port_cfg("bert-large", "fused"), jparams, batches[:1],
                              (True,))[1]
    finally:
        plm.Placement.use = _ORIG_USE
    res["ce"] = _ce_run(mesh, ce_inputs)
    res["refused"] = _refusals(mesh)
    torch.save(res, f"{out}/rank{rank}.pt")
    mesh.close()


def _ce_inputs():
    rs = np.random.default_rng(3)
    b, s, v = 4, 16, 512
    logits = (rs.standard_normal((b, s, v)) * 3).astype(np.float32)
    targets = rs.integers(0, v, size=(b, s)).astype(np.int64)
    mask = (rs.random((b, s)) > 0.2).astype(np.float32)
    segments = np.sort(rs.integers(-1, 3, size=(b, s)), axis=1).astype(np.int32)
    return logits, targets, mask, segments


def _jax_runs(inputs):
    import jax
    import jax.numpy as jnp

    from repro.train import trainer as jtr
    from test_torch_train import _cfgs
    from torch_fast_jit import fast_jit

    want = {}
    for arch in ARCHS:
        jp, batches = inputs[arch]
        jcfg, _ = _cfgs(arch, "reference", "vr_lamb", **_opt(arch))
        jstate = jtr.init_state(jcfg, params=jp)
        step = jtr.make_train_step(jcfg, log_gsnr=True)[0]
        jstep = {fresh: fast_jit(lambda s, b, fresh=fresh: step(s, b, fresh))
                 for fresh in set(FRESH)}
        want[arch] = []
        for batch, with_stats in zip(batches, FRESH):
            jstate, jm = jstep[with_stats](jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            want[arch].append(jax.device_get((jstate, jm)))
    return want


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """(every rank's results, the JAX runs, the inputs): the ranks run while
    the JAX side computes."""
    import jax

    from repro.data import lm_batches as j_lm_batches
    from repro.models import transformer as jt
    from test_torch_train import _cfgs

    tmp = tmp_path_factory.mktemp("grid")
    ctx = start_ranks(_rank, WORLD, args=(f"file://{tmp}/rdzv", str(tmp)))
    inputs = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch, "reference")
        jp = jax.device_get(jt.init_params(jcfg.model, jax.random.PRNGKey(0)))
        stream = j_lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
        inputs[arch] = (jp, [next(stream) for _ in FRESH])
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump((inputs, _ce_inputs()), f)
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
    want = _jax_runs(inputs)
    wait_ranks(ctx, DEADLINE_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, want, inputs, tmp


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_steps_match_the_single_device_reference(grid_runs, arch, plan):
    from test_torch_distributed import _as_state
    from test_torch_train import _compare

    ranks, want, _, _ = grid_runs
    for r, res in enumerate(ranks):
        snaps = res[arch, plan]
        assert len(snaps) == len(FRESH)
        for i, snap in enumerate(snaps):
            _compare(*want[arch][i], _as_state(snap), snap["metrics"], i)
            assert ("gsnr/mean" in snap["metrics"]) == FRESH[i]
            assert snap["metrics"] == ranks[0][arch, plan][i]["metrics"], (r, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_blocks_and_replicas_agree(grid_runs, arch):
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import model_layout
    from repro_torch.sharding.placement import held_elements, shard_shape
    from repro_torch.sharding.rules import Rules

    ranks, _, _, _ = grid_runs
    layout = model_layout(get_smoke(arch).model)
    sizes = {"data": GRID[0], "model": GRID[1]}
    rules = Rules(mesh=types.SimpleNamespace(shape=sizes, axis_names=("data", "model")))
    specs = {p: rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)}
    shapes = dict(zip(layout.paths, layout.shapes))
    want_held = held_elements(shapes, specs, sizes)
    total = sum(layout.sizes)
    assert 0.24 * total < want_held < 0.27 * total, (want_held, total)
    for plan in PLANS:
        for res in ranks:
            held = res[arch, plan, "held"]
            assert held["held"] == want_held
            assert tuple(held["specs"]) == tuple(specs[p] for p in layout.paths)
            # the optimizer state: the local layout (fused), the blocks (reference)
            want_state = (held["rows"], 128) if plan == "fused" else want_held
            assert set(held["state"].values()) == {want_state}, held["state"]
            assert held["rows"] < layout.n_rows
        from repro_torch.core.layout import ParamLayout

        local = ParamLayout(layout.paths, tuple(shard_shape(shapes[p], specs[p], sizes)
                                                for p in layout.paths))
        for i in range(len(FRESH)):
            views = [local.leaf_views(res[arch, plan][i]["local"]) for res in ranks]
            for n, (path, spec) in enumerate(specs.items()):
                for a in range(WORLD):
                    for b in range(a + 1, WORLD):
                        ca, cb = ranks[a]["coords"], ranks[b]["coords"]
                        if all(ca[x] == cb[x] for x in spec.axes()):
                            assert torch.equal(views[a][n], views[b][n]), (plan, i, path, a, b)


def test_a_planted_double_count_across_the_model_axis_fails(grid_runs):
    """The replicated leaves' gradients summed over the model axis (module
    docstring): the first step no longer matches the reference."""
    from test_torch_distributed import _as_state
    from test_torch_train import _compare

    ranks, want, _, _ = grid_runs
    snap, = ranks[0]["planted"]
    _compare(*want["bert-large"][0], _as_state(ranks[0]["bert-large", "fused"][0]),
             ranks[0]["bert-large", "fused"][0]["metrics"], 0)
    with pytest.raises(AssertionError):
        _compare(*want["bert-large"][0], _as_state(snap), snap["metrics"], 0)


def test_vocab_parallel_cross_entropy_matches_the_plain_loss(grid_runs):
    from repro_torch.train.loss import cross_entropy, document_cross_entropy

    ranks, _, _, _ = grid_runs
    logits, targets, mask, segments = (torch.as_tensor(x) for x in _ce_inputs())
    for name, fn in (("token", lambda z: cross_entropy(z, targets, mask)),
                     ("document", lambda z: document_cross_entropy(z, targets, segments,
                                                                   mask))):
        z = logits.clone().requires_grad_(True)
        loss = fn(z)
        loss.backward()
        v = logits.shape[-1] // GRID[1]
        for res in ranks:
            assert res["ce"]["vocab_tp"]
            got, grad, j = res["ce"][name]
            np.testing.assert_allclose(got, float(loss.detach()), rtol=1e-6, err_msg=name)
            torch.testing.assert_close(grad, z.grad[..., j * v:(j + 1) * v], rtol=0, atol=1e-7)


def test_unported_paths_raise_on_the_grid(grid_runs):
    ranks, _, _, _ = grid_runs
    for res in ranks:
        assert set(res["refused"]) == set(REFUSED)
        for case, msg in res["refused"].items():
            assert msg is not None and "ROADMAP A9.4b" in msg, (case, msg)


def test_grid_checkpoint_restores_whole_and_into_the_grid(grid_runs):
    from repro_torch.core.layout import pad_mask
    from repro_torch.train import init_state
    from repro_torch.train.checkpoint import restore

    ranks, _, _, tmp = grid_runs
    assert all(res["ckpt"] for res in ranks)
    last = ranks[0]["bert-large", "fused"][-1]
    back = restore(str(tmp / "grid.npz"), init_state(_port_cfg("bert-large", "fused"),
                                                     device="cpu"))
    assert torch.equal(back.params.data, last["params"])
    assert back.step == last["step"] == len(FRESH)
    live = pad_mask(back.params.layout)
    for nm in "mvp":
        assert torch.equal(back.opt_state[nm].data[live], last["opt_state"][nm].data[live]), nm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tensor_parallel_products_round_as_one_card(dtype):
    """placement.py's column and row products over M = 2 splits, the model
    axis's sums taken in one process, against one card's products in
    ``dtype``: the column products' outputs and weight gradients are one
    card's columns; their input gradients' f32 partials sum to the f32
    product (rtol 1e-5) and, cast once, to one card's input gradient; the
    row products' f32 partials sum to the f32 product and, cast once, to
    one card's output; their gradients are one card's rows.  "One card's"
    within one rounding of ``dtype`` (assert_close's defaults for it)."""
    from repro_torch.sharding.placement import _ColProduct, _RowProduct

    g = torch.Generator().manual_seed(0)
    x, w, dy = (torch.randn(*s, generator=g).to(dtype) for s in ((2, 8, 32), (32, 48), (2, 8, 48)))
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = xr @ wr
    y.backward(dy)
    m, n = 2, 48 // 2
    xe = x.float().requires_grad_(True)
    for j in range(m):
        cols = slice(j * n, (j + 1) * n)
        wj = w[:, cols].clone().requires_grad_(True)
        yj = _ColProduct.apply(xe, wj)
        assert yj.dtype == dtype
        torch.testing.assert_close(yj, y[..., cols].detach())
        yj.backward(dy[..., cols])
        torch.testing.assert_close(wj.grad, wr.grad[:, cols])
    assert xe.grad.dtype == torch.float32
    torch.testing.assert_close(xe.grad, dy.float() @ w.float().T, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xe.grad.to(dtype), xr.grad)

    h = y.detach()  # (2, 8, 48) into a (48, 32) row-parallel weight
    wd = torch.randn(48, 32, generator=g).to(dtype)
    hr, wdr = h.clone().requires_grad_(True), wd.clone().requires_grad_(True)
    out = hr @ wdr
    dz = torch.randn(out.shape, generator=g).to(dtype)
    out.backward(dz)
    total = 0.0
    for j in range(m):
        rows = slice(j * n, (j + 1) * n)
        hj = h[..., rows].clone().requires_grad_(True)
        wdj = wd[rows].clone().requires_grad_(True)
        part = _RowProduct.apply(hj, wdj)
        assert part.dtype == torch.float32
        part.backward(dz.float())
        torch.testing.assert_close(hj.grad, hr.grad[..., rows])
        torch.testing.assert_close(wdj.grad, wdr.grad[rows])
        total = total + part.detach()
    torch.testing.assert_close(total, h.float() @ wd.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total.to(dtype), out.detach())
