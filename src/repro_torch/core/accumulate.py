"""k-group gradient moment accumulation (the paper's ``k``).

Port of ``repro/core/accumulate.py`` (method "scan").  The paper equates k
with gradient-accumulation groups (Appendix Table 9); GradStats come from k
microbatches, each one forward and backward.  The reference's ``lax.scan``
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

Not yet ported: ``method="vmap"``, which raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.backend import Backend
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, FlatParams, tree_map


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

    loss_fn(params_tree, microbatch) -> (loss, aux dict of scalars); it is
    called on ``params.tree`` and its loss backpropagated into
    ``params.grad``.  GradStats holds FlatBuffers on the fused ``stats``
    plan and stacked trees on the reference plan; with ``squares=False``
    its sq_mean is None (no Σg² stream)."""
    if method != "scan":
        raise NotImplementedError(f"grad_stats(method={method!r}) is not yet ported; use 'scan'")
    bk = backend if backend is not None else Backend()
    fused = bk.fused("stats", params.device)
    mb = split_batch(batch, k)
    from repro_torch.kernels import ops as kops

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


def grad_only(loss_fn: Callable, params: FlatParams, batch: Dict):
    """(loss, aux, gradient) of one backward over the whole batch (the
    baseline optimizers; no moment of squares).  The gradient is the
    stacked tree of views of ``params.grad``."""
    params.zero_grad()
    loss, aux = loss_fn(params.tree, batch)
    loss.backward()
    return loss.detach(), {n: v.detach() for n, v in aux.items()}, params.stacked("grad")
