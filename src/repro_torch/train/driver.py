"""A generic VR-or-baseline step loop and the rank AUC.

Port of ``benchmarks/common.py::train_optimizer`` and ``::auc``, the
reference's training driver for its paper-table benchmarks (DLRM, CIFAR and
linear-regression proxies), where the model is a plain loss over a params
tree rather than a transformer config.

One step of a VR optimizer is ``grad_stats`` over ``opt_cfg.k`` microbatches
(core/accumulate.py: on the fused ``stats`` plan K3 per microbatch and K4),
then ``opt.update(stats.mean, state, w, stats=stats)`` (on the fused
``optimizer`` plan one kernel call: K8 for VR-SGD/Momentum) and
``params += upd`` in place on the flat buffer; a baseline step is one
backward over the whole batch (``grad_only``) and the tree update.  As in
the reference there is no grad clip and no norm.  The plan's stats and
optimizer subsystems may resolve differently (core/vrgd.py crosses the
flat boundary).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.backend import Backend
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.accumulate import grad_only, grad_stats
from repro_torch.core.layout import FlatBuffer, FlatParams, tree_map
from repro_torch.core.vrgd import make_optimizer
from repro_torch.serve.engine import resolve_device


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney rank AUC, tied scores sharing their mean rank."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = ranks[order[i: j + 1]].mean()
        i = j + 1
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def train_optimizer(
    loss_fn: Callable,
    params,
    batches: Iterable,
    opt_cfg: OptimizerConfig,
    steps: int,
    eval_fn: Optional[Callable] = None,
    target: Optional[float] = None,
    backend: Optional[Backend] = None,
    device=None,
    callback: Optional[Callable] = None,
) -> Dict:
    """Train ``steps`` steps; returns {params, losses, final_loss,
    steps_to_target, s_per_step, step_s} and, with ``eval_fn``, eval.

    ``loss_fn(params_tree, batch) -> (loss, aux)``; ``params`` is a
    FlatParams on ``device`` (updated in place and returned) or a params tree
    (copied into a new one-group FlatParams there); ``batches`` yields dicts
    of arrays or tensors, moved to the device.  ``s_per_step`` is the mean
    and ``step_s`` each step's host wall, from taking the batch to the
    loss on the host (which waits for the device).  ``callback(i, params,
    loss)`` runs after step i, outside the walls; ``eval_fn(params)`` after
    the last step."""
    device = resolve_device(device)
    if isinstance(params, FlatParams):
        if params.device.type != device.type or device.index not in (None, params.device.index):
            raise ValueError(f"the params lie on {params.device}, not on {device}")
        flat = params
    else:
        flat = FlatParams(params, 1, device=device)
    bk = backend if backend is not None else Backend()
    opt = make_optimizer(opt_cfg, backend=bk)
    is_vr = opt_cfg.is_vr
    flat_form = is_vr and bk.fused("optimizer", device)

    def step(state, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if is_vr:
            loss, _, stats = grad_stats(loss_fn, flat, batch, opt_cfg.k, backend=bk)
            grads = stats.mean
        else:
            loss, _, grads = grad_only(loss_fn, flat, batch)
            stats = None
        w = FlatBuffer(flat.data, flat.layout) if flat_form else flat.stacked()
        with torch.no_grad():
            upd, state = opt.update(grads, state, w, stats=stats)
            tree_map(lambda p, u: p.add_(u), w, upd)
        return state, loss

    state = opt.init(flat)
    it = iter(batches)
    losses, walls = [], []
    steps_to_target = None
    for i in range(steps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step(state, next(it))
        loss = float(loss)
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if target is not None and steps_to_target is None and loss <= target:
            steps_to_target = i + 1
        if callback is not None:
            callback(i, flat, loss)
    out = {
        "params": flat,
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "steps_to_target": steps_to_target,
        "s_per_step": sum(walls) / max(steps, 1),
        "step_s": walls,
    }
    if eval_fn is not None:
        out["eval"] = eval_fn(flat)
    return out
