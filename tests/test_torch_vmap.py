"""Port parity of the vmap GSNR-stats method: one vmapped forward and
backward over the k groups (core/accumulate.py, ``method="vmap"``), its
stack reduction (K10, ``flat_stats.flat_vmap_moments``), and the pieces
that make the model batch under ``torch.func`` (the attention autograd
Function's vmap rules, the remat Function, the loss).

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs its Pallas kernels in interpret mode and its train step on its
reference plan; the port's kernel wrappers, given CPU tensors, compute
their plain versions.  Every test here runs with functorch's "performance
drop" warning turned into an error: that warning marks an op without a
batching rule, which torch then runs as a loop over the groups.

Tolerances:
  * K10: the mean exact (the same f32 additions in the same order, times
    the same f32 1/k); sq_mean rtol 1e-6 (XLA may fuse g*g + s into one
    FMA where the plain version rounds the product first).
  * the autograd Functions under ``vmap(grad(...))`` against a loop over
    the groups of plain autograd: exact (the same ops on the same rows;
    folding the groups into the batch axis changes no sum).
  * grad_stats(method="vmap") against method="scan": the reference's own
    bound for the same comparison (tests/test_accumulate.py, rtol 1e-4),
    plus atol 1e-6 of the buffer's largest magnitude for means that cancel
    to ~0 across the groups (the batched products sum in another order;
    measured <= 4e-7 beyond the rtol, internlm2 without remat; the other
    cases agree exactly); loss and aux rtol 1e-5.
  * the train step against the JAX package's vmap step: test_torch_train.py's
    tolerances, unchanged (its ``_compare``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis.registry import demo_layout
from repro.kernels import flat_stats as jfs
from repro.models import transformer as jt
from repro.train import trainer as jtr
from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.core.accumulate import grad_stats
from repro_torch.core.layout import FlatParams, ParamLayout, is_flat, tree_map, tree_paths
from repro_torch.data import lm_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import flat_stats as fs
from repro_torch.models import init_params
from repro_torch.models.transformer import remat
from repro_torch.train import init_state, make_train_step
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.loss import make_loss_fn
from test_torch_train import _cfgs, _compare, _packed_batch

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes here are small: one intra-op thread is as fast alone and
    keeps this file from oversubscribing the cores the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FALLBACK = "There is a performance drop"
pytestmark = pytest.mark.filterwarnings(f"error:{FALLBACK}:UserWarning")


def _counted(monkeypatch, mod, name, log):
    """Replace ``mod.name`` with a wrapper that appends its first operand's
    leading (batch) size to ``log`` on every call."""
    fn = getattr(mod, name)

    def wrapper(*args, **kw):
        log.append(args[0].shape[0])
        return fn(*args, **kw)

    monkeypatch.setattr(mod, name, wrapper)


# ---- K10 -------------------------------------------------------------------


def _stack(layout, k, rng):
    """(k, n_rows, 128) f32: k random trees packed into the layout (zero
    tails), with exactly zero elements sprinkled in."""
    rows = []
    for _ in range(k):
        x = rng.standard_normal((layout.n_rows * 128,)).astype(np.float32)
        x[rng.random(x.shape) < 0.05] = 0.0
        buf = np.zeros_like(x)
        for off, size in zip(layout.row_offsets, layout.sizes):
            buf[off * 128: off * 128 + size] = x[off * 128: off * 128 + size]
        rows.append(buf.reshape(-1, 128))
    return np.stack(rows)


@pytest.mark.parametrize("kind,k", [("aligned", 8), ("hostile", 8), ("hostile", 7)])
def test_vmap_moments_match_the_pallas_kernel(kind, k):
    jl = demo_layout(kind)
    gstack = _stack(jl, k, np.random.default_rng(k))
    want_m, want_sq = (np.asarray(x) for x in
                       jfs.flat_vmap_moments(jnp.asarray(gstack), jl, k, interpret=True))
    t = torch.from_numpy(gstack)
    for fn in (fs.vmap_moments_ref, fs.flat_vmap_moments):
        mean, sq = fn(t, k)
        assert mean.shape == (jl.n_rows, 128) and mean.dtype == torch.float32
        np.testing.assert_array_equal(mean.numpy(), want_m)
        np.testing.assert_allclose(sq.numpy(), want_sq, rtol=1e-6, atol=0)
    # the padded tails stay exactly zero
    mask = np.zeros(jl.n_rows * 128, bool)
    for off, size in zip(jl.row_offsets, jl.sizes):
        mask[off * 128: off * 128 + size] = True
    assert not mean.numpy().reshape(-1)[~mask].any() and not sq.numpy().reshape(-1)[~mask].any()


def test_vmap_moments_checks_the_stack():
    with pytest.raises(ValueError, match="stack of 3 slices, k=4"):
        fs.flat_vmap_moments(torch.zeros(3, 8, 128), 4)


def test_pack_stack_matches_packing_each_group():
    """FlatParams.pack_stack writes each group's gradient where its
    parameter lives: slice j of the stack equals packing group j's tree."""
    cfg = get_smoke("internlm2-1.8b")  # two layer groups
    flat = FlatParams(init_params(cfg.model, torch.Generator().manual_seed(0)),
                      cfg.model.n_groups())
    k = 3
    rng = np.random.default_rng(0)
    grads = tree_map(lambda x: torch.from_numpy(
        rng.standard_normal((k, *x.shape)).astype(np.float32)), flat.tree)
    stack = flat.pack_stack(grads, k)
    assert stack.shape == (k, flat.layout.n_rows, 128)
    for j in range(k):
        tree = tree_map(lambda g: g[j], grads)
        want = FlatParams(tree, cfg.model.n_groups()).data
        torch.testing.assert_close(stack[j], want, rtol=0, atol=0)


# ---- the autograd Functions under vmap(grad) ---------------------------------


@pytest.mark.parametrize("causal,packed", [(True, False), (False, False), (True, True)])
def test_flash_attention_fn_under_vmap_grad(causal, packed, monkeypatch):
    """vmap(grad) through FlashAttentionFn gives the gradients of a loop over
    the groups, with ONE forward and ONE backward call over all k groups
    folded into the batch axis."""
    k, b, s, h, kvh, d = 3, 2, 16, 4, 2, 16
    rng = np.random.default_rng(1)
    q, kk, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for shape in ((k, b, s, h, d), (k, b, s, kvh, d), (k, b, s, kvh, d)))
    w = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32))
    pos = None
    if packed:
        pos = torch.tensor([[0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 0, 1, -1, -1, -1]] * b,
                           dtype=torch.int32)

    def f(w, q, kk, v):
        out = fa.flash_attention_train(q @ w, kk, v, pos, pos, causal=causal)
        return (out * out).sum()

    fwd, bwd = [], []
    _counted(monkeypatch, fa, "attention_fwd_ref", fwd)
    _counted(monkeypatch, fab, "attention_bwd_ref", bwd)
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2, 3)),
                          in_dims=(None, 0, 0, 0))(w, q, kk, v)
    assert fwd == [k * b] and bwd == [k * b]
    for i in range(k):
        leaves = [t.clone().requires_grad_(True) for t in (w, q[i], kk[i], v[i])]
        f(*leaves).backward()
        for g, leaf in zip(got, leaves):
            torch.testing.assert_close(g[i], leaf.grad, rtol=0, atol=0)


def _remat_group(monkeypatch):
    """bert-large smoke's first layer group with fused attention (plain
    versions on the CPU) and inputs for k = 2 groups; returns (params, x,
    f(gp, x, use_remat) -> scalar, forward batch sizes, backward batch
    sizes), the sizes appended at each attention call."""
    cfg = get_smoke("bert-large")
    pcfg = dataclasses.replace(cfg.parallel, compute_dtype="float32",
                               backend=Backend.all_fused())
    from repro_torch.models.transformer import _block_apply, _block_body

    params = init_params(cfg.model, torch.Generator().manual_seed(0))
    gp = params["groups"][0]
    k, b, s, dm = 2, 2, 8, cfg.model.d_model
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((k, b, s, dm))
                         .astype(np.float32))
    q_pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    last = len(cfg.model.block_pattern) - 1
    blk = dict(q_pos=q_pos, cache=None, mode="train", cache_len=0, implicit_layout=True,
               seg_base=None)

    def group_body(xx, gp, q_pos, q_seg, seg_base):
        for i, kind in enumerate(cfg.model.block_pattern[:last]):
            xx, _, _ = _block_apply(cfg.model, pcfg, kind, gp[f"pos{i}"], xx,
                                    **{**blk, "q_pos": q_pos}, q_seg=q_seg)
        xx, h, _, _ = _block_body(cfg.model, pcfg, cfg.model.block_pattern[last],
                                  gp[f"pos{last}"], xx, **{**blk, "q_pos": q_pos}, q_seg=q_seg)
        return xx, h

    def f(gp, xx, use_remat):
        if use_remat:
            y = remat(group_body, xx, gp, (f"pos{last}", "mlp", "wd"), q_pos, None, None)
        else:
            xr, h = group_body(xx, gp, q_pos, None, None)
            y = xr + h @ gp[f"pos{last}"]["mlp"]["wd"]
        return (y * y).mean()

    fwd, bwd = [], []
    _counted(monkeypatch, fa, "attention_fwd_ref", fwd)
    _counted(monkeypatch, fab, "attention_bwd_ref", bwd)
    return gp, x, f, fwd, bwd


def test_remat_function_under_vmap_grad(monkeypatch):
    """The remat Function (a layer group with fused attention) under
    vmap(grad): the gradients of plain autograd without remat, per group;
    the group runs its forward twice (forward, recompute) and its backward
    once, each once for all k groups."""
    gp, x, f, fwd, bwd = _remat_group(monkeypatch)
    k, b = x.shape[:2]
    got = torch.func.vmap(torch.func.grad(lambda p, xx: f(p, xx, True)),
                          in_dims=(None, 0))(gp, x)
    n_blocks = len(get_smoke("bert-large").model.block_pattern)
    assert fwd == [k * b] * (2 * n_blocks) and bwd == [k * b] * n_blocks
    for i in range(k):
        leaves = tree_map(lambda t: t.clone().requires_grad_(True), gp)
        f(leaves, x[i], False).backward()
        for (path, g), (_, leaf) in zip(tree_paths(got), tree_paths(leaves)):
            torch.testing.assert_close(g[i], leaf.grad, rtol=1e-6, atol=1e-7, msg=path)


def test_remat_function_under_autograd(monkeypatch):
    """The same remat Function under plain autograd (the scan method's
    backward): the gradients, to x and the leaves, of the group without
    remat, the forward run twice and the backward once."""
    gp, x, f, fwd, bwd = _remat_group(monkeypatch)
    b = x.shape[1]
    n_blocks = len(get_smoke("bert-large").model.block_pattern)
    for i in range(x.shape[0]):
        got, want = (tree_map(lambda t: t.clone().requires_grad_(True), gp) for _ in "gw")
        xg, xw = (x[i].clone().requires_grad_(True) for _ in "gw")
        fwd.clear(), bwd.clear()
        f(got, xg, True).backward()
        assert fwd == [b] * (2 * n_blocks) and bwd == [b] * n_blocks
        f(want, xw, False).backward()
        torch.testing.assert_close(xg.grad, xw.grad, rtol=1e-6, atol=1e-7)
        for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
            torch.testing.assert_close(g.grad, w.grad, rtol=1e-6, atol=1e-7, msg=path)


class _GemmCount(TorchDispatchMode):
    """Counts the matrix products (aten mm / addmm / bmm) run under it."""

    OPS = ("mm", "addmm", "bmm")

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket.__name__ in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("under_vmap", [False, True])
def test_remat_recompute_skips_the_last_projection(under_vmap, monkeypatch):
    """The remat backward reruns the group's forward up to its last
    projection and no further: its matrix products exceed those of the
    backward without remat by the group's forward count minus one (the
    last block's ``wd`` product is not rerun), under autograd and
    ``vmap(grad)`` alike."""
    gp, x, f, _, _ = _remat_group(monkeypatch)
    xx = x if under_vmap else x[0]

    def count(use_remat):
        with _GemmCount() as fwd_count:
            if under_vmap:  # vmap(grad) runs forward and backward in one call
                torch.func.vmap(torch.func.grad(lambda p, xi: f(p, xi, use_remat)),
                                in_dims=(None, 0))(gp, xx)
                return fwd_count.n, None
            leaves = tree_map(lambda t: t.clone().requires_grad_(True), gp)
            loss = f(leaves, xx, use_remat)
        with _GemmCount() as bwd_count:
            loss.backward()
        return fwd_count.n, bwd_count.n

    if under_vmap:
        (n_remat, _), (n_plain, _) = count(True), count(False)
        with _GemmCount() as fwd_only, torch.no_grad():
            torch.func.vmap(lambda xi: f(gp, xi, False))(xx)
        assert n_remat - n_plain == fwd_only.n - 1
    else:
        (f_remat, b_remat), (f_plain, b_plain) = count(True), count(False)
        assert f_remat == f_plain > 1
        assert b_remat - b_plain == f_plain - 1


# ---- grad_stats(method="vmap") against method="scan" --------------------------


def _stats_np(stats, layout):
    if is_flat(stats):
        return stats.data.numpy()
    return layout.pack(stats).numpy()


def _stats_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


GRAD_STATS_CASES = [  # (arch, packed, plan, remat): both plans with remat on and off, then
    # the packed rows' document loss and internlm2's RoPE/GQA on one plan each way
    *[("bert-large", False, plan, remat) for plan in ("reference", "fused")
      for remat in (True, False)],
    ("bert-large", True, "fused", True), ("bert-large", True, "reference", False),
    ("internlm2-1.8b", False, "fused", True), ("internlm2-1.8b", False, "reference", False),
]


@pytest.mark.parametrize("arch,packed,plan,remat_on", GRAD_STATS_CASES)
def test_grad_stats_vmap_matches_scan(arch, packed, plan, remat_on, monkeypatch):
    cfg = get_smoke(arch)
    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32",
                                                   backend=bk, remat=remat_on),
                      loss_norm="document" if packed else "token")
    params = init_params(cfg.model, torch.Generator().manual_seed(0))
    flat = FlatParams(params, cfg.model.n_groups())
    if packed:
        batch = _packed_batch(cfg.global_batch, cfg.seq_len, cfg.model.vocab_size, 0)
    else:
        batch = next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len))
    batch = {n: torch.as_tensor(x) for n, x in batch.items()}
    k = cfg.optimizer.k
    loss_fn = make_loss_fn(cfg)
    fwd = []
    _counted(monkeypatch, fa, "attention_fwd_ref", fwd)
    out = {m: grad_stats(loss_fn, flat, batch, k, method=m, backend=bk) for m in ("scan", "vmap")}
    if plan == "fused":  # the vmap step folds the k groups into each attention call
        b = cfg.global_batch
        grouped = cfg.model.n_groups() * len(cfg.model.block_pattern)
        per_pass = grouped * (2 if remat_on else 1) + cfg.model.n_layers - grouped
        assert fwd == [b // k] * (per_pass * k) + [b] * per_pass
    (l_s, aux_s, st_s), (l_v, aux_v, st_v) = out["scan"], out["vmap"]
    np.testing.assert_allclose(float(l_v), float(l_s), rtol=1e-5)
    assert set(aux_v) == set(aux_s)
    for name in aux_s:
        np.testing.assert_allclose(float(aux_v[name]), float(aux_s[name]), rtol=1e-5)
    assert is_flat(st_v.mean) == (plan == "fused") and st_v.k == k
    for key in ("mean", "sq_mean"):
        _stats_close(_stats_np(getattr(st_v, key), flat.layout),
                     _stats_np(getattr(st_s, key), flat.layout))
    # g-only (a stale step's carry): the same mean, no squares
    _, _, st_g = grad_stats(loss_fn, flat, batch, k, method="vmap", squares=False, backend=bk)
    assert st_g.sq_mean is None
    _stats_close(_stats_np(st_g.mean, flat.layout), _stats_np(st_s.mean, flat.layout))


def test_grad_stats_rejects_an_unknown_method():
    cfg = get_smoke("bert-large")
    flat = FlatParams(init_params(cfg.model, torch.Generator().manual_seed(0)), 1)
    with pytest.raises(ValueError, match="method='loop' must be one of"):
        grad_stats(make_loss_fn(cfg), flat, {}, 2, method="loop")


def test_a_vmap_fallback_inside_the_step_raises():
    """The error filter is live: an op without a batching rule (histc) in
    the loss makes the vmap stats step raise instead of looping over k."""
    cfg = get_smoke("bert-large")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=Backend.all_fused()))
    flat = FlatParams(init_params(cfg.model, torch.Generator().manual_seed(0)), 1)
    batch = {n: torch.as_tensor(x) for n, x in
             next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len)).items()}
    inner = make_loss_fn(cfg)

    def loss_fn(params, mb):
        loss, aux = inner(params, mb)
        return loss + 0.0 * torch.histc(loss.detach()[None], bins=2).sum(), aux

    grad_stats(inner, flat, batch, 2, method="vmap")
    with pytest.raises(UserWarning, match=FALLBACK):
        grad_stats(loss_fn, flat, batch, 2, method="vmap")


# ---- the train step against the JAX package's vmap step -----------------------


@pytest.fixture(scope="module")
def jax_vmap_runs():
    """{optimizer: (init params, [(state, metrics)] of a fresh then a stale
    step)} of the JAX train step with stats_method="vmap"."""
    cache = {}

    def run(name):
        if name not in cache:
            jcfg, _ = _cfgs("bert-large", "reference", name, stats_method="vmap")
            jp = jt.init_params(jcfg.model, jax.random.PRNGKey(0))
            jstate = jtr.init_state(jcfg, params=jp)
            jstep = jax.jit(jtr.make_train_step(jcfg, log_gsnr=True)[0], static_argnums=2)
            stream = lm_batches(jcfg.model.vocab_size, jcfg.global_batch, jcfg.seq_len)
            hist = []
            for with_stats in (True, False):
                batch = {n: jnp.asarray(x) for n, x in next(stream).items()}
                jstate, jm = jstep(jstate, batch, with_stats)
                hist.append(jax.device_get((jstate, jm)))
            cache[name] = (jax.device_get(jp), hist)
        return cache[name]

    return run


@pytest.mark.parametrize("plan", ["reference", "fused"])
@pytest.mark.parametrize("name", ["vr_lamb", "vr_adam"])
def test_vmap_train_step_matches_reference(name, plan, jax_vmap_runs):
    """A fresh then a stale step of the port's vmap train step against the
    JAX package's, from the same params and batches."""
    jp, hist = jax_vmap_runs(name)
    _, tcfg = _cfgs("bert-large", plan, name, stats_method="vmap")
    state = init_state(tcfg, params=params_from_numpy(jp, tcfg.model), device="cpu")
    step = make_train_step(tcfg, log_gsnr=True, device="cpu")[0]
    stream = lm_batches(tcfg.model.vocab_size, tcfg.global_batch, tcfg.seq_len)
    for i, with_stats in enumerate((True, False)):
        state, tm = step(state, next(stream), with_stats)
        jstate, jm = hist[i]
        _compare(jstate, jm, state, tm, i)
        assert ("gsnr/mean" in tm) == with_stats
    assert is_flat(state.opt_state["m"]) == (plan == "fused")
    assert isinstance(state.params.layout, ParamLayout)
