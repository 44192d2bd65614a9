"""VRGD optimizers (the paper's contribution, sec. 4 + Appendix D).

Port of ``repro/core/vrgd.py``.  Each VR optimizer consumes ``GradStats``
(the k-group gradient moments) and element-wise rescales the gradient by the
normalized, clipped GSNR ``r`` in [gamma, 1] before (or, for VR-SGD, inside)
the base update:

  VR-SGD      theta <- theta - lr * r * g                          (Alg. 1)
  VR-Momentum r*g into heavy-ball momentum, m = mu m + r g         (sec. 4.2)
  VR-Adam     p_t = b3*p + (1-b3)*r ; ghat = p̂_t * g ; Adam(ghat)  (Alg. 3)
  VR-LARS     r*g into LARS                                        (sec. 4.2)
  VR-LAMB     VR-Adam direction + LAMB layer-wise trust ratio      (Alg. 5)

The ratio derives from the raw group moments (stats.mean, stats.sq_mean)
but scales the gradient that enters the update (``grads``, which the global
grad clip may have rescaled).  VR-Adam/LAMB moments are stored in
``state_dtype`` with all math in f32; VR-Momentum and VR-LARS keep m in
f32.  The GSNR-momentum bias correction counts stats refreshes (``pt``).
``gamma=1.0`` collapses r to exactly 1, so every VR optimizer reduces to its
base optimizer (core/baselines.py).

Dispatch follows the plan's ``optimizer`` subsystem (repro_torch.backend),
resolved for the device the parameters live on at ``init`` and for the
gradient's device at ``update``.  A gradient, params or GradStats in the
other form cross the flat boundary on entry, as in the reference (its
``_unpacked`` and ``as_flat``), so the stats and optimizer subsystems may
resolve differently: a FlatBuffer is unpacked to the stacked tree (views)
for the reference math, a tree is packed into the layout (of the state or
the params where they are flat) for the fused update.  The state is never
converted: ``update`` raises if its form disagrees with the plan.  Fused
keeps the state as flat buffers (core/layout.py), returns FlatBuffers, and
runs a fresh-stats update as one kernel wrapper call through
kernels/ops.py: ``flat_vr_scale`` for VR-SGD/Momentum (the momentum sum and
-lr are then plain torch, as in the reference), ``flat_vr_adam``,
``flat_vr_lamb``, ``flat_vr_lars``.  Reference runs the per-leaf tree math
below on the reference's stacked tree.

Under a data mesh the fused VR optimizers take the ``spmd`` plan of
``Backend.shard(mesh)`` (backend.FlatSpmd), as in the reference: ``init``
then holds only the rank's rows of the flat state (core/layout.py::
RowShard) and ``update`` returns the rank's rows of the update, which the
trainer gathers.  On a GridMesh (backend.GridSpmd) every buffer and tree
holds the rank's spec blocks: the fused updates run the same pipelines on
the rank's local buffer, and the reference plan's per-leaf GSNR means and
LARS's and LAMB's norms (the baselines' too) are the whole leaves', each
leaf summed from its owners (``GridSpmd.tree_leaf_means``,
``tree_lars_trust``, ``tree_lamb_trust``).

Amortized-GSNR "stale" steps (``stats=None``, VR-Adam and VR-LAMB only):
the GSNR momentum p is left untouched and the stale p̂ rescales the fresh
gradient.  On flat state the element-wise math below runs directly on the
flat buffers (plain torch, no kernel), and VR-LAMB's trust ratio is
``kernels/ops.py::lamb_trust_flat``.  Under a mesh the gradient and the
state are the rank's rows, the chain runs on them and the trust ratio's
per-leaf sums are combined with one all-reduce (``FlatSpmd.lamb_trust``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.backend import Backend, GridSpmd
from repro_torch.core import baselines as B
from repro_torch.core.gsnr import GradStats, gsnr_scale
from repro_torch.core.layout import (FlatBuffer, FlatParams, ParamLayout, is_flat, shard_rows,
                                     tree_leaves, tree_map, unpack_tree)


def _require(stats: Optional[GradStats]) -> GradStats:
    if stats is None:
        raise ValueError("VR optimizers require GradStats (mean + sq_mean); see "
                         "core/accumulate.py")
    return stats


def _zeros(bk: Backend, params: FlatParams, dtype=torch.float32, spmd=None):
    """Zero state of the plan resolved for the params' device: a flat buffer
    when it is fused (the rank's rows of it when ``spmd`` shards it), the
    stacked tree otherwise."""
    if bk.fused("optimizer", params.device):
        shard = spmd.shard(params.layout) if spmd is not None else None
        if shard is not None:
            return FlatBuffer(shard.zeros(dtype, params.device), params.layout, shard)
        return FlatBuffer(params.layout.zeros(dtype, params.device), params.layout)
    return B.zeros_tree(params, dtype)


def _crossed(bk: Backend, name: str, grads, state, params=None, stats=None,
             reads_params: bool = True):
    """(fused, grads, params, stats) in the form of the plan resolved for the
    gradient's device: on the reference plan a FlatBuffer is unpacked to the
    stacked tree (views, no copy), on the fused plan a tree is packed into
    the layout of the flat state, params or moments (new buffers).  An
    optimizer that does not read the params passes ``reads_params=False``:
    they then only lend their layout, and None comes back in their place.
    Raises if the state (m) is in the other form."""
    device = tree_leaves(grads)[0].device
    fused = bk.fused("optimizer", device)
    m = state.get("m")
    if m is not None and is_flat(m) != fused:
        raise ValueError(
            f"{name}: the state is {'flat' if is_flat(m) else 'a tree'} but the plan resolves "
            f"optimizer={bk.resolve('optimizer', device)!r} on {device}; init the state on the "
            "device the update runs on")
    means = None if stats is None else stats.mean
    layout = next((x.layout for x in (m, params, grads, means) if is_flat(x)), None)
    if fused and layout is None:
        layout = ParamLayout.for_tree(grads)

    crossed = {}  # VR-SGD's gradient is the moments' mean: packed once

    def form(x):
        if x is None or is_flat(x) == fused:
            return x
        if id(x) not in crossed:
            crossed[id(x)] = FlatBuffer(layout.pack(x), layout) if fused else unpack_tree(x)
        return crossed[id(x)]

    if stats is not None:
        stats = stats._replace(mean=form(stats.mean), sq_mean=form(stats.sq_mean))
    return fused, form(grads), form(params) if reads_params else None, stats


def _like(params, d):
    """The params in the form of the direction ``d``: the rank's rows of
    the whole flat buffer when ``d`` holds a row shard."""
    if is_flat(d) and d.shard is not None:
        return shard_rows(params, d.shard)
    return params


def bias_corrections(state, b1: float, b2: float, b3: float, fresh: bool = True):
    """(t, pt, bc1, bc2, bc3) of a step, in float32 as the reference computes
    them: b1/b2 correct by the optimizer step, b3 by the stats-refresh
    counter pt, which a stale step (``fresh=False``) does not advance."""
    t = state["step"] + 1
    pt = state.get("pt", state["step"]) + int(fresh)
    return (t, pt, B.bias_correction(b1, t), B.bias_correction(b2, t),
            B.bias_correction(b3, pt))


def _grid(spmd) -> Optional[GridSpmd]:
    """The plan when it is a GridMesh's: the reference plan's trees then
    hold a rank's blocks, whose per-leaf means and norms are the whole
    leaves' (backend.GridSpmd)."""
    return spmd if isinstance(spmd, GridSpmd) else None


def _leaf_means(spmd):
    grid = _grid(spmd)
    return None if grid is None else grid.tree_leaf_means


def _scaled_grads(grads, stats, gamma, eps, fused, spmd=None):
    """(r * grads, r): one kernel call on the fused plan (the rank's rows
    under a sharding plan), tree math otherwise."""
    stats = _require(stats)
    if fused:
        from repro_torch.kernels import ops as kops

        return kops.vr_scale_tree(stats, grads, gamma, eps, spmd)
    r = gsnr_scale(stats, gamma, eps, _leaf_means(spmd))
    return tree_map(lambda r_, g: r_ * g, r, grads), r


def vr_sgd(lr_fn: Callable, gamma: float = 0.1, eps: float = 1e-12,
           backend: Optional[Backend] = None, spmd=None) -> B.Transform:
    bk = backend if backend is not None else Backend()

    def init(params: FlatParams):
        return {"step": 0}

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        fused, grads, _, stats = _crossed(bk, "vr_sgd", grads, state, params, stats,
                                          reads_params=False)
        sg, _r = _scaled_grads(grads, stats, gamma, eps, fused, spmd)
        return tree_map(lambda g: -lr * g, sg), {"step": state["step"] + 1}

    return B.Transform(init, update)


def vr_momentum(lr_fn: Callable, mu: float = 0.9, gamma: float = 0.1, eps: float = 1e-12,
                backend: Optional[Backend] = None, spmd=None) -> B.Transform:
    bk = backend if backend is not None else Backend()

    def init(params: FlatParams):
        return {"step": 0, "m": _zeros(bk, params, spmd=spmd)}

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        fused, grads, _, stats = _crossed(bk, "vr_momentum", grads, state, params, stats,
                                          reads_params=False)
        sg, _r = _scaled_grads(grads, stats, gamma, eps, fused, spmd)
        m = tree_map(lambda m_, g: mu * m_ + g, state["m"], sg)
        return tree_map(lambda m_: -lr * m_, m), {"step": state["step"] + 1, "m": m}

    return B.Transform(init, update)


def _vr_adam_dir(grads, state, stats, b1, b2, b3, eps, gamma, gsnr_eps, state_dtype="float32",
                 leaf_means=None):
    """Shared VR-Adam machinery (Alg. 3 lines 8-17) on trees or FlatBuffers:
    returns (direction, new_state).  Moments are stored in state_dtype, math
    in f32.  With ``stats=None`` (a stale step) p is left as it is and the
    stale p̂ rescales the fresh gradient; pt does not advance.
    ``leaf_means``: see core/gsnr.py::normalize_per_layer."""
    t, pt, bc1, bc2, bc3 = bias_corrections(state, b1, b2, b3, fresh=stats is not None)
    sd = getattr(torch, state_dtype)
    f32 = lambda tree: tree_map(lambda x: x.float(), tree)
    store = lambda tree: tree_map(lambda x: x.to(sd), tree)
    p = f32(state["p"])
    if stats is not None:
        r = gsnr_scale(stats, gamma, gsnr_eps, leaf_means)
        p = tree_map(lambda p_, r_: b3 * p_ + (1 - b3) * r_, p, r)
    ghat = tree_map(lambda p_, g: (p_ / bc3) * g, p, grads)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, f32(state["m"]), ghat)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, f32(state["v"]), ghat)
    direction = tree_map(lambda m_, v_: (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps), m, v)
    return direction, {"step": t, "m": store(m), "v": store(v), "p": store(p), "pt": pt}


def _adam_state(bk: Backend, params: FlatParams, state_dtype: str, spmd=None):
    sd = getattr(torch, state_dtype)
    return {"step": 0, "pt": 0, **{k: _zeros(bk, params, sd, spmd) for k in "mvp"}}


def vr_adam(
    lr_fn: Callable,
    b1: float = 0.9,
    b2: float = 0.999,
    b3: float = 0.9,
    eps: float = 1e-8,
    wd: float = 0.0,
    gamma: float = 0.1,
    gsnr_eps: float = 1e-12,
    backend: Optional[Backend] = None,
    state_dtype: str = "float32",
    spmd=None,
) -> B.Transform:
    """VR-Adam; the weight decay ``wd * w`` is added only when params are
    given."""
    bk = backend if backend is not None else Backend()

    def init(params: FlatParams):
        return _adam_state(bk, params, state_dtype, spmd)

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        fused, grads, params, stats = _crossed(bk, "vr_adam", grads, state, params, stats)
        if fused and stats is not None:
            from repro_torch.kernels import ops as kops

            return kops.vr_adam_update(grads, state, stats, lr, b1, b2, b3, eps, wd, gamma,
                                       gsnr_eps, params, state_dtype, spmd)
        d, new_state = _vr_adam_dir(grads, state, stats, b1, b2, b3, eps, gamma, gsnr_eps,
                                    state_dtype, _leaf_means(spmd))
        if wd and params is not None:
            d = tree_map(lambda d_, p_: d_ + wd * p_, d, _like(params, d))
        return tree_map(lambda d_: -lr * d_, d), new_state

    return B.Transform(init, update)


def vr_lars(
    lr_fn: Callable,
    mu: float = 0.9,
    wd: float = 1e-4,
    trust: float = 0.001,
    gamma: float = 0.1,
    eps: float = 1e-12,
    backend: Optional[Backend] = None,
    spmd=None,
) -> B.Transform:
    bk = backend if backend is not None else Backend()
    base = B.lars(lr_fn, mu=mu, wd=wd, trust=trust, grid=_grid(spmd))

    def init(params: FlatParams):
        return {"step": 0, "m": _zeros(bk, params, spmd=spmd)}

    def update(grads, state, params, stats=None):
        fused, grads, params, stats = _crossed(bk, "vr_lars", grads, state, params, stats)
        if fused:
            from repro_torch.kernels import ops as kops

            return kops.vr_lars_update(grads, state, _require(stats), lr_fn(state["step"]), mu,
                                       wd, trust, gamma, eps, params, spmd)
        sg, _r = _scaled_grads(grads, stats, gamma, eps, False, spmd)
        return base.update(sg, state, params)

    return B.Transform(init, update)


def vr_lamb(
    lr_fn: Callable,
    b1: float = 0.9,
    b2: float = 0.999,
    b3: float = 0.9,
    eps: float = 1e-6,
    wd: float = 0.01,
    gamma: float = 0.1,
    gsnr_eps: float = 1e-12,
    backend: Optional[Backend] = None,
    state_dtype: str = "float32",
    spmd=None,
) -> B.Transform:
    """VR-LAMB.  ``init`` takes the FlatParams and resolves the plan's
    ``optimizer`` subsystem for the device they live on: flat m/v/p when it
    is fused, stacked trees otherwise.  ``update(grads, state, params,
    stats)`` takes the gradient to apply, the params and the GradStats (None
    on a stale step), each a FlatBuffer or the stacked tree (crossed into the
    plan's form on entry), and returns (updates in the plan's form: a
    FlatBuffer on the fused plan, the stacked tree otherwise, new state)."""
    bk = backend if backend is not None else Backend()

    def init(params: FlatParams):
        return _adam_state(bk, params, state_dtype, spmd)

    def update(grads, state, params, stats=None):
        lr = lr_fn(state["step"])
        fused, grads, params, stats = _crossed(bk, "vr_lamb", grads, state, params, stats)
        from repro_torch.kernels import ops as kops

        if fused and stats is not None:
            return kops.vr_lamb_update(grads, state, stats, lr, b1, b2, b3, eps, wd, gamma,
                                       gsnr_eps, params, state_dtype, spmd)
        grid = _grid(spmd)
        d, new_state = _vr_adam_dir(grads, state, stats, b1, b2, b3, eps, gamma, gsnr_eps,
                                    state_dtype, _leaf_means(spmd))
        if fused:
            return kops.lamb_trust_flat(d, params, lr, wd, spmd), new_state
        if grid is not None:
            return grid.tree_lamb_trust(d, params, lr, wd), new_state
        return tree_map(lambda d_, p_: B.lamb_trust(d_, p_, lr, wd), d, params), new_state

    return B.Transform(init, update)


def make_optimizer(cfg, backend: Optional[Backend] = None,
                   effective_batch: Optional[int] = None, *, spmd=None) -> B.Transform:
    """OptimizerConfig -> Transform (base or VR per cfg.name); the plan
    resolves for the parameters' device at ``init``.  effective_batch: the
    live global batch (the schedule peak rescales through cfg.lr_scale_rule
    when cfg.base_batch is set).  spmd: a ``Backend.shard(mesh)`` plan; the
    fused VR updates then run per row shard (the baselines ignore it), and
    on a GridMesh's plan (backend.GridSpmd) every optimizer's per-leaf means
    and norms are the whole leaves' (LARS's and LAMB's trust ratios too)."""
    from repro_torch.core.schedule import make_schedule

    lr_fn = make_schedule(cfg, effective_batch=effective_batch)
    g, ge, bk = cfg.gamma, cfg.gsnr_eps, backend
    table = {
        "sgd": lambda: B.sgd(lr_fn),
        "momentum": lambda: B.momentum(lr_fn, cfg.momentum),
        "adam": lambda: B.adam(lr_fn, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay),
        "lars": lambda: B.lars(lr_fn, cfg.momentum, cfg.weight_decay, grid=_grid(spmd)),
        "lamb": lambda: B.lamb(lr_fn, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay,
                               grid=_grid(spmd)),
        "vr_sgd": lambda: vr_sgd(lr_fn, g, ge, bk, spmd),
        "vr_momentum": lambda: vr_momentum(lr_fn, cfg.momentum, g, ge, bk, spmd),
        "vr_adam": lambda: vr_adam(lr_fn, cfg.b1, cfg.b2, cfg.b3, cfg.eps, cfg.weight_decay, g,
                                   ge, bk, cfg.state_dtype, spmd),
        "vr_lars": lambda: vr_lars(lr_fn, cfg.momentum, cfg.weight_decay, gamma=g, eps=ge,
                                   backend=bk, spmd=spmd),
        "vr_lamb": lambda: vr_lamb(lr_fn, cfg.b1, cfg.b2, cfg.b3, cfg.eps, cfg.weight_decay, g,
                                   ge, bk, cfg.state_dtype, spmd),
    }
    if cfg.name not in table:
        raise KeyError(f"unknown optimizer {cfg.name!r}")
    return table[cfg.name]()
