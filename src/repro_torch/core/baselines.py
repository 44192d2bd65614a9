"""Baseline optimizers: SGD, Momentum, Adam(W), LARS, LAMB.

Port of ``repro/core/baselines.py``: the paper's comparison points (paper
Appendix D, Alg. 2/4/6) and the substrate the VR variants wrap.  Minimal
optax-like interface:

    Transform.init(params)                              -> state
    Transform.update(grads, state, params, stats=None)  -> (updates, state)

updates are deltas: theta <- theta + updates.  ``stats`` is accepted and
ignored, so VR and base optimizers are interchangeable in the trainer.

As in the reference, the baselines are tree math on either plan and launch
no kernel: ``init`` takes the FlatParams and keeps its state as f32 trees in
the shape of the reference's stacked tree (``FlatParams.stacked()``);
``update`` takes grads and params as such trees.  Step counters and the
learning rate are host numbers; bias corrections are computed in float32
as the reference computes them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.layout import FlatParams, tree_map


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _tensor_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.float())))


def _lamb_phi(x: torch.Tensor) -> torch.Tensor:
    """LAMB's phi: clip ||w|| to [0, 10]."""
    return torch.clamp(x, 0.0, 10.0)


def bias_correction(b: float, t) -> float:
    """1 - b^t in float32 (t a step count, at least 1)."""
    f32 = np.float32
    return float(f32(1) - f32(b) ** max(f32(t), f32(1)))


def zeros_tree(params: FlatParams, dtype=torch.float32):
    """Zeros in the shape of the stacked param tree, on the params' device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype, device=x.device),
                    params.stacked())


def lars_trust(g, p, trust: float, wd: float) -> torch.Tensor:
    """One leaf of LARS: ratio * (g + wd p), ratio = trust ||w|| / ||g + wd p||
    where both norms are > 0, else 1."""
    g_ = g + wd * p
    pn, gn = _tensor_norm(p), _tensor_norm(g_)
    ratio = torch.where((pn > 0) & (gn > 0), trust * pn / (gn + 1e-12), torch.ones_like(pn))
    return ratio * g_


def lamb_trust(d, p, lr: float, wd: float) -> torch.Tensor:
    """One leaf of LAMB's update: -lr * ratio * (d + wd p), ratio =
    phi(||w||) / ||d + wd p|| where both norms are > 0, else 1."""
    u = d + wd * p
    pn, un = _tensor_norm(p), _tensor_norm(u)
    ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12), torch.ones_like(pn))
    return -lr * ratio * u


def sgd(lr_fn: Callable) -> Transform:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        return tree_map(lambda g: -lr * g, grads), {"step": state["step"] + 1}

    return Transform(init, update)


def momentum(lr_fn: Callable, mu: float = 0.9) -> Transform:
    def init(params):
        return {"step": 0, "m": zeros_tree(params)}

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        m = tree_map(lambda m_, g: mu * m_ + g, state["m"], grads)
        return tree_map(lambda m_: -lr * m_, m), {"step": state["step"] + 1, "m": m}

    return Transform(init, update)


def _adam_dir(grads, state, b1, b2, eps):
    t = state["step"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g), state["v"], grads)
    bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
    direction = tree_map(lambda m_, v_: (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps), m, v)
    return direction, m, v


def adam(lr_fn: Callable, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         wd: float = 0.0) -> Transform:
    def init(params):
        return {"step": 0, "m": zeros_tree(params), "v": zeros_tree(params)}

    def update(grads, state, params=None, stats=None):
        lr = lr_fn(state["step"])
        d, m, v = _adam_dir(grads, state, b1, b2, eps)
        if wd and params is not None:
            d = tree_map(lambda d_, p: d_ + wd * p, d, params)
        upd = tree_map(lambda d_: -lr * d_, d)
        return upd, {"step": state["step"] + 1, "m": m, "v": v}

    return Transform(init, update)


def lars(lr_fn: Callable, mu: float = 0.9, wd: float = 1e-4, trust: float = 0.001,
         grid=None) -> Transform:
    """You et al. 2017 [arXiv:1708.03888]: layer-wise (per-tensor) trust ratio.
    ``grid`` (backend.GridSpmd): the trees hold a rank's blocks and the trust
    ratio takes the whole leaves' norms (``GridSpmd.tree_lars_trust``)."""

    def init(params):
        return {"step": 0, "m": zeros_tree(params)}

    def update(grads, state, params, stats=None):
        lr = lr_fn(state["step"])
        if grid is not None:
            m = tree_map(lambda m_, t: mu * m_ + t, state["m"],
                         grid.tree_lars_trust(grads, params, trust, wd))
        else:
            m = tree_map(lambda g, m_, p: mu * m_ + lars_trust(g, p, trust, wd), grads,
                         state["m"], params)
        return tree_map(lambda m_: -lr * m_, m), {"step": state["step"] + 1, "m": m}

    return Transform(init, update)


def lamb(lr_fn: Callable, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         wd: float = 0.01, grid=None) -> Transform:
    """You et al. 2020 [arXiv:1904.00962] (paper Alg. 6).  ``grid`` as for
    ``lars`` (``GridSpmd.tree_lamb_trust``)."""

    def init(params):
        return {"step": 0, "m": zeros_tree(params), "v": zeros_tree(params)}

    def update(grads, state, params, stats=None):
        lr = lr_fn(state["step"])
        d, m, v = _adam_dir(grads, state, b1, b2, eps)
        if grid is not None:
            upd = grid.tree_lamb_trust(d, params, lr, wd)
        else:
            upd = tree_map(lambda d_, p: lamb_trust(d_, p, lr, wd), d, params)
        return upd, {"step": state["step"] + 1, "m": m, "v": v}

    return Transform(init, update)
