"""VRGD optimizers (the paper's contribution, sec. 4 + Appendix D): VR-LAMB.

Port of the VR-LAMB path of ``repro/core/vrgd.py``:

  VR-Adam direction  p_t = b3*p + (1-b3)*r ; ghat = p̂_t * g ; Adam(ghat)  (Alg. 3)
  VR-LAMB            VR-Adam direction + LAMB layer-wise trust ratio      (Alg. 5)

with r the normalized, clipped GSNR (core/gsnr.py) in [gamma, 1].  The ratio
derives from the raw group moments (stats.mean, stats.sq_mean) but scales
the gradient that enters the update (``grads``, which the global grad clip
may have rescaled).  Moments are stored in ``state_dtype`` with all math in
f32; the GSNR-momentum bias correction counts stats refreshes (``pt``).

Dispatch follows the plan's ``optimizer`` subsystem (repro_torch.backend),
resolved for the device the parameters live on: fused keeps m/v/p as flat
buffers (core/layout.py) and runs the whole update as one call of the
kernel wrapper ``kernels/flat_update.py::flat_vr_lamb`` (through
kernels/ops.py); reference runs the per-leaf tree math below on the
reference's stacked tree.

Not yet ported: the stale-GSNR step (``stats=None``), the other VR
optimizers (vr_sgd, vr_momentum, vr_adam, vr_lars) and the baselines (sgd,
momentum, adam, lars, lamb); ``make_optimizer`` raises for them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.backend import Backend
from repro_torch.core import baselines as B
from repro_torch.core.gsnr import GradStats, gsnr_scale
from repro_torch.core.layout import FlatBuffer, FlatParams, is_flat, tree_leaves, tree_map

NOT_PORTED = ("sgd", "momentum", "adam", "lars", "lamb", "vr_sgd", "vr_momentum", "vr_adam",
              "vr_lars")


def _require(stats: Optional[GradStats]) -> GradStats:
    if stats is None:
        raise ValueError(
            "vr_lamb: GradStats (mean + sq_mean) are required; the stale-GSNR step "
            "(stats=None) is not yet ported"
        )
    return stats


def bias_corrections(state, b1: float, b2: float, b3: float):
    """(t, pt, bc1, bc2, bc3) of a fresh-stats step, in float32 as the
    reference computes them: b1/b2 correct by the optimizer step, b3 by the
    stats-refresh counter pt."""
    f32 = np.float32
    t = state["step"] + 1
    pt = state.get("pt", state["step"]) + 1
    tf, ptf = f32(t), max(f32(pt), f32(1))
    bcs = [float(f32(1) - f32(b) ** x) for b, x in ((b1, tf), (b2, tf), (b3, ptf))]
    return t, pt, *bcs


def _vr_adam_dir(grads, state, stats, b1, b2, b3, eps, gamma, gsnr_eps, state_dtype="float32"):
    """Shared VR-Adam machinery on trees (Alg. 3 lines 8-17): returns
    (direction, new_state).  Moments are stored in state_dtype, math in f32."""
    t, pt, bc1, bc2, bc3 = bias_corrections(state, b1, b2, b3)
    sd = getattr(torch, state_dtype)
    f32 = lambda tree: tree_map(lambda x: x.float(), tree)
    store = lambda tree: tree_map(lambda x: x.to(sd), tree)
    r = gsnr_scale(_require(stats), gamma, gsnr_eps)
    p = tree_map(lambda p_, r_: b3 * p_ + (1 - b3) * r_, f32(state["p"]), r)
    ghat = tree_map(lambda p_, g: (p_ / bc3) * g, p, grads)
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, f32(state["m"]), ghat)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, f32(state["v"]), ghat)
    direction = tree_map(lambda m_, v_: (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps), m, v)
    return direction, {"step": t, "m": store(m), "v": store(v), "p": store(p), "pt": pt}


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
) -> B.Transform:
    """VR-LAMB.  ``init`` takes the FlatParams and resolves the plan's
    ``optimizer`` subsystem for the device they live on: flat m/v/p when it
    is fused, stacked trees otherwise.  ``update(grads, state, params,
    stats)`` takes the gradient to apply (FlatBuffer on the fused plan, the
    stacked tree otherwise), the params in the same form and the GradStats,
    and returns (updates in that form, new state)."""
    bk = backend if backend is not None else Backend()
    sd = getattr(torch, state_dtype)

    def init(params: FlatParams):
        if bk.fused("optimizer", params.device):
            z = lambda: FlatBuffer(params.layout.zeros(sd, params.device), params.layout)
        else:
            z = lambda: tree_map(lambda x: torch.zeros(x.shape, dtype=sd, device=x.device),
                                 params.stacked())
        return {"step": 0, "pt": 0, "m": z(), "v": z(), "p": z()}

    def update(grads, state, params, stats=None):
        lr = lr_fn(state["step"])
        fused = is_flat(state["m"])
        device = tree_leaves(params)[0].device
        if fused != bk.fused("optimizer", device):
            raise ValueError(
                f"vr_lamb: the state is {'flat' if fused else 'a tree'} but the plan resolves "
                f"optimizer={bk.resolve('optimizer', device)!r} on {device}; init the state "
                "on the device the update runs on")
        if fused:
            from repro_torch.kernels import ops as kops

            return kops.vr_lamb_update(grads, state, _require(stats), lr, b1, b2, b3, eps, wd,
                                       gamma, gsnr_eps, params, state_dtype)
        d, new_state = _vr_adam_dir(grads, state, stats, b1, b2, b3, eps, gamma, gsnr_eps,
                                    state_dtype)

        def one(d_, p_):
            u = d_ + wd * p_
            pn, un = B._tensor_norm(p_), B._tensor_norm(u)
            ok = (pn > 0) & (un > 0)
            ratio = torch.where(ok, B._lamb_phi(pn) / (un + 1e-12), torch.ones_like(pn))
            return -lr * ratio * u

        return tree_map(one, d, params), new_state

    return B.Transform(init, update)


def make_optimizer(cfg, backend: Optional[Backend] = None,
                   effective_batch: Optional[int] = None) -> B.Transform:
    """OptimizerConfig -> Transform.  Only ``vr_lamb`` is ported; the plan
    resolves for the parameters' device at ``init``.  effective_batch: the
    live global batch (the schedule peak rescales through
    cfg.lr_scale_rule when cfg.base_batch is set)."""
    from repro_torch.core.schedule import make_schedule

    if cfg.name in NOT_PORTED:
        raise KeyError(f"optimizer {cfg.name!r} is not yet ported to repro_torch; "
                       "the port has vr_lamb")
    if cfg.name != "vr_lamb":
        raise KeyError(f"unknown optimizer {cfg.name!r}")
    lr_fn = make_schedule(cfg, effective_batch=effective_batch)
    return vr_lamb(lr_fn, cfg.b1, cfg.b2, cfg.b3, cfg.eps, cfg.weight_decay, cfg.gamma,
                   cfg.gsnr_eps, backend, cfg.state_dtype)
