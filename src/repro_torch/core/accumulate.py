"""k-group gradient moment accumulation (the paper's ``k``).

Port of ``repro/core/accumulate.py`` (methods "scan" and "vmap").  The
paper equates k with gradient-accumulation groups (Appendix Table 9);
GradStats come from k microbatches, each one forward and backward.  The reference's ``lax.scan``
becomes a Python loop.

The parameters are a FlatParams (core/layout.py): every microbatch's
backward writes its gradient straight into the flat gradient buffer.  On
the fused ``stats`` plan that buffer feeds the flat (g_sum, g2_sum) carry,
one kernel launch per microbatch, and one finalize launch divides by k
(kernels/flat_stats.py through kernels/ops.py).  A stale-GSNR step
(``squares=False``) keeps only g_sum: one g-only launch per microbatch, then
the /k as one plain in-place multiply, as the reference does it outside a
kernel.  On the reference plan the carry is a tree over the reference's
stacked leaves, added with plain torch.  ``grad_only`` is the baselines'
single backward over the whole batch.

``method="vmap"`` takes the k microbatches through ONE batched forward and
backward: ``torch.func.vmap`` of ``torch.func.grad_and_value`` over the
groups, with respect to the detached per-group leaves of ``params.tree``
(the model's kernels fold the vmapped dim into their batch axis, so each
runs once per layer for all k groups).  On the fused plan the (k, param)
gradients are written into one (k, n_rows, LANE) f32 stack, which reduces
to (mean, sq_mean) in one K10 launch; a stale step takes the stack's mean
as a plain op, as the reference does.  On the reference plan the moments
are tree means over the k axis.  It costs the stack: k f32 copies of the
parameters.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.backend import Backend
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, FlatParams, stack_groups, tree_map

METHODS = ("scan", "vmap")


def split_batch(batch: Dict, k: int) -> Dict:
    """Reshape every leaf (B, ...) -> (k, B//k, ...).

    Raises a loud ValueError when the batch size doesn't divide into k
    accumulation groups, with both numbers and the remainder."""
    if k < 1:
        raise ValueError(f"split_batch: k={k} must be a positive group count")
    if not batch:
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(
            f"split_batch: batch_size={b} is not divisible by k={k} "
            f"accumulation groups (remainder {b % k}). Pick k from the "
            f"divisors of the batch size."
        )
    out = {}
    for name, x in batch.items():
        if x.shape[0] != b:
            raise ValueError(f"split_batch: ragged batch — leaf {name!r} with leading dim "
                             f"{x.shape[0]} alongside {b}")
        out[name] = x.reshape(k, b // k, *x.shape[1:])
    return out


def grad_stats(
    loss_fn: Callable,
    params: FlatParams,
    batch: Dict,
    k: int,
    *,
    method: str = "scan",
    squares: bool = True,
    backend: Optional[Backend] = None,
) -> Tuple[torch.Tensor, Dict, GradStats]:
    """(mean loss, mean aux, GradStats) over k microbatches.

    loss_fn(params_tree, microbatch) -> (loss, aux dict of scalars); under
    "scan" it is called on ``params.tree`` and its loss backpropagated into
    ``params.grad``, under "vmap" differentiated by ``torch.func`` (see the
    module note).  GradStats holds FlatBuffers on the fused ``stats``
    plan and stacked trees on the reference plan; with ``squares=False``
    its sq_mean is None (no Σg² stream)."""
    if method not in METHODS:
        raise ValueError(f"grad_stats: method={method!r} must be one of {METHODS}")
    bk = backend if backend is not None else Backend()
    fused = bk.fused("stats", params.device)
    mb = split_batch(batch, k)
    from repro_torch.kernels import ops as kops

    if method == "vmap":
        return _vmap_stats(loss_fn, params, mb, k, squares, fused)

    if fused and squares:
        g_sum, g2_sum = kops.moments_init_flat(params.layout, params.device)
    elif fused:
        g_sum = params.layout.zeros(torch.float32, params.device)
    else:
        g_sum = tree_map(torch.zeros_like, params.stacked())
        g2_sum = tree_map(torch.zeros_like, g_sum) if squares else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=params.device)
    aux_sum: Dict = {}
    for i in range(k):
        params.zero_grad()
        loss, aux = loss_fn(params.tree, {name: x[i] for name, x in mb.items()})
        loss.backward()
        loss_sum += loss.detach()
        for name, val in aux.items():
            aux_sum[name] = aux_sum.get(name, 0.0) + val.detach()
        if fused and squares:
            kops.moments_accum_flat(g_sum, g2_sum, params.grad)
        elif fused:
            kops.g_accum_flat(g_sum, params.grad)
        else:
            grads = params.stacked("grad")
            tree_map(lambda a, g: a.add_(g), g_sum, grads)
            if squares:
                tree_map(lambda a, g: a.add_(g * g), g2_sum, grads)
    inv = float(np.float32(1.0) / np.float32(k))
    if fused and squares:
        stats = kops.moments_finalize_flat(g_sum, g2_sum, k, params.layout)
    elif fused:
        stats = GradStats(mean=FlatBuffer(g_sum.mul_(inv), params.layout), sq_mean=None, k=k)
    else:
        scale = lambda tree: tree_map(lambda x: x.mul_(inv), tree)
        stats = GradStats(mean=scale(g_sum), sq_mean=scale(g2_sum) if squares else None, k=k)
    return loss_sum * inv, {n: v * inv for n, v in aux_sum.items()}, stats


def _vmap_stats(loss_fn, params: FlatParams, mb: Dict, k: int, squares: bool, fused: bool):
    """grad_stats(method="vmap") over the split batch ``mb``."""
    from repro_torch.kernels import ops as kops

    gfn = torch.func.grad_and_value(loss_fn, has_aux=True)
    grads, (loss, aux) = torch.func.vmap(gfn, in_dims=(None, 0))(params.detached_tree(), mb)
    if fused:
        gstack = params.pack_stack(grads, k)
        del grads
        if squares:
            stats = kops.vmap_moments_flat(gstack, k, params.layout)
        else:
            stats = GradStats(mean=FlatBuffer(gstack.mean(dim=0), params.layout), sq_mean=None,
                              k=k)
    else:
        stats = GradStats(
            mean=stack_groups(tree_map(lambda g: g.mean(dim=0), grads)),
            sq_mean=stack_groups(tree_map(lambda g: g.square().mean(dim=0), grads))
            if squares else None,
            k=k)
    return loss.detach().mean(), {n: v.detach().mean(dim=0) for n, v in aux.items()}, stats


def grad_only(loss_fn: Callable, params: FlatParams, batch: Dict):
    """(loss, aux, gradient) of one backward over the whole batch (the
    baseline optimizers; no moment of squares).  The gradient is the
    stacked tree of views of ``params.grad``."""
    params.zero_grad()
    loss, aux = loss_fn(params.tree, batch)
    loss.backward()
    return loss.detach(), {n: v.detach() for n, v in aux.items()}, params.stacked("grad")
