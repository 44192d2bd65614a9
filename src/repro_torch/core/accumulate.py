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

Under a data mesh (``spmd``, a ``Backend.shard(mesh)`` plan of W > 1
ranks; the reference's ``pjit`` step, whose mesh path equals its
single-device step) every rank holds the global batch and takes its rows
of each of the k groups, so the groups are the single-card step's.  Each
rank's loss is divided by its group's global live count / W (the loss
function's ``denominator``, handed over as the batch entry LOSS_DENOM), so
the ranks' losses and gradients average to the group's however the pads
fall.  On the fused plan a group's flat gradient is reduce-scattered x 1/W
into the rank's rows, and K3 (K9 on a stale step) and K4 run over the
rank's rows of the carry, which therefore equal the single-card carry's
rows; the vmap method reduce-scatters each slice of its stack and runs K10
over the rows.  On the reference plan the flat gradient (or stack) is
all-reduced x 1/W whole and the tree carry is replicated.  The loss and aux
are the ranks' means (one all-reduce).

On a GridMesh (``spmd`` a ``backend.GridSpmd``; the weights' FSDP+TP
sharding) ``params`` is a core/layout.py::GridParams: the data ranks split
each group's rows as above (the model ranks of a data row take the same
rows), each backward leaves the rank's blocks of the gradient already
summed over the data axis (the weights' gathers, sharding/placement.py),
and the 1/D scale is the only step between it and the carry: K3 (K9) and
K4 over the rank's local buffer on the fused plan, the tree carry over its
blocks on the reference plan.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.backend import Backend, GridSpmd
from repro_torch.core.distributed import mean_over_ranks
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, FlatParams, stack_groups, tree_map
from repro_torch.kernels.flat_stats import inv_k

METHODS = ("scan", "vmap")
# The batch entry that carries a rank's loss denominator under a mesh
# (train/loss.py reads it): its group's live-token or live-document count
# over all the ranks' rows, / W.
LOSS_DENOM = "loss_denom"


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


def _mesh_of(spmd):
    """The mesh whose ranks split each group's rows (the data axis of a
    GridMesh) when the plan's mesh has more than one rank, else None."""
    if isinstance(spmd, GridSpmd):
        return spmd.batch_mesh
    return spmd.batch_mesh if spmd is not None and spmd.mesh.size > 1 else None


def _rank_rows(x: torch.Tensor, size: int, rank: int, dim: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``x``'s rows along ``dim``, of ``size``
    equal blocks."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"a group of {n} rows does not split over {size} ranks "
                         f"(remainder {n % size})")
    per = n // size
    return x.narrow(dim, rank * per, per).contiguous()


def _denominator(loss_fn: Callable) -> Callable:
    denom = getattr(loss_fn, "denominator", None)
    if denom is None:
        raise ValueError(
            "under a mesh the loss function needs a `denominator` (train/loss.py::make_loss_fn): "
            "each rank's own mean, averaged, weighs the ranks' rows wrongly when their live "
            "counts differ")
    return denom


def _rank_groups(loss_fn: Callable, mb: Dict, mesh) -> Dict:
    """This rank's rows of each of the k groups of a split batch ``mb``
    (leaves (k, B/k, ...) -> (k, B/(k W), ...)) and the (k,) leaf
    LOSS_DENOM: each group's global denominator (``loss_fn.denominator``)
    / W, so that the ranks' losses, averaged, are the group's loss over all
    its rows whatever rows each rank holds."""
    denom = _denominator(loss_fn)
    out = {name: _rank_rows(x, mesh.size, mesh.rank, 1) for name, x in mb.items()}
    k = next(iter(mb.values())).shape[0]
    out[LOSS_DENOM] = torch.stack(
        [denom({name: x[i] for name, x in mb.items()}) for i in range(k)]) / mesh.size
    return out


def rank_split_loss(loss_fn: Callable, world: int) -> Callable:
    """A one-card loss that takes a batch as ``world`` ranks of a mesh take
    each group: one forward per rank's block of rows, each divided by the
    batch's denominator / ``world`` as ``_rank_groups`` divides it, and the
    blocks' mean.  Its gradient is rounded as the mesh's is (each block's
    backward alone, the blocks summed in f32, times 1/world), so a one-card
    step with it is a mesh step's reference up to summation order, where
    one backward over the whole group rounds its gradient once."""
    denom_of = _denominator(loss_fn)

    def fn(params, batch):
        denom = denom_of(batch) / world
        parts = [loss_fn(params, {**{name: _rank_rows(x, world, r, 0)
                                     for name, x in batch.items()}, LOSS_DENOM: denom})
                 for r in range(world)]
        mean = lambda xs: torch.stack(xs).sum() * inv_k(world)
        return (mean([loss for loss, _ in parts]),
                {name: mean([aux[name] for _, aux in parts]) for name in parts[0][1]})

    fn.denominator = denom_of
    return fn


def grad_stats(
    loss_fn: Callable,
    params: FlatParams,
    batch: Dict,
    k: int,
    *,
    method: str = "scan",
    squares: bool = True,
    backend: Optional[Backend] = None,
    spmd=None,
) -> Tuple[torch.Tensor, Dict, GradStats]:
    """(mean loss, mean aux, GradStats) over k microbatches.

    loss_fn(params_tree, microbatch) -> (loss, aux dict of scalars); under
    "scan" it is called on ``params.tree`` and its loss backpropagated into
    ``params.grad``, under "vmap" differentiated by ``torch.func`` (see the
    module note).  GradStats holds FlatBuffers on the fused ``stats``
    plan and stacked trees on the reference plan; with ``squares=False``
    its sq_mean is None (no Σg² stream).

    ``spmd`` (``Backend.shard(mesh)``) of a mesh of W > 1 ranks runs the
    data-parallel form (module note): ``batch`` is the global batch, every
    rank returns the same loss and aux, and on the fused plan the moments
    are the rank's rows (FlatBuffers with a ``shard``)."""
    if method not in METHODS:
        raise ValueError(f"grad_stats: method={method!r} must be one of {METHODS}")
    bk = backend if backend is not None else Backend()
    fused = bk.fused("stats", params.device)
    mb = split_batch(batch, k)
    mesh = _mesh_of(spmd)
    grid = isinstance(spmd, GridSpmd)
    plan = spmd if (fused and mesh is not None) else None
    if mesh is not None:
        mb = _rank_groups(loss_fn, mb, mesh)
    from repro_torch.kernels import ops as kops

    if method == "vmap":
        if grid:
            spmd.reduce_stack_rows(None, params.layout)  # raises: not ported on a grid
        return _vmap_stats(loss_fn, params, mb, k, squares, fused, mesh, plan)

    layout = params.layout
    if fused and squares:
        g_sum, g2_sum = kops.moments_init_flat(layout, params.device, plan)
    elif fused:
        g_sum = kops.flat_zeros(layout, params.device, plan)
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
        g = params.grad
        if grid:  # the rank's blocks, summed over the data axis by the gathers: x 1/D
            g = spmd.reduce_rows(g, layout)
        elif plan is not None:  # the rank's rows of the ranks' mean gradient
            g = plan.reduce_rows(g, layout)
        elif mesh is not None:  # the whole mean gradient, in place
            mesh.all_reduce_(g).mul_(inv_k(mesh.size))
        if fused and squares:
            kops.moments_accum_flat(g_sum, g2_sum, g, layout, plan)
        elif fused:
            kops.g_accum_flat(g_sum, g, layout, plan)
        else:
            grads = params.stacked("grad")
            tree_map(lambda a, g_: a.add_(g_), g_sum, grads)
            if squares:
                tree_map(lambda a, g_: a.add_(g_ * g_), g2_sum, grads)
    inv = inv_k(k)
    if fused and squares:
        stats = kops.moments_finalize_flat(g_sum, g2_sum, k, layout, plan)
    elif fused:
        shard = None if plan is None else plan.shard(layout)
        stats = GradStats(mean=FlatBuffer(g_sum.mul_(inv), layout, shard), sq_mean=None, k=k)
    else:
        scale = lambda tree: tree_map(lambda x: x.mul_(inv), tree)
        stats = GradStats(mean=scale(g_sum), sq_mean=scale(g2_sum) if squares else None, k=k)
    loss, aux = loss_sum * inv, {n: v * inv for n, v in aux_sum.items()}
    if mesh is not None:
        loss, aux = mean_over_ranks(mesh, loss, aux)
    return loss, aux, stats


def _vmap_stats(loss_fn, params: FlatParams, mb: Dict, k: int, squares: bool, fused: bool,
                mesh, plan):
    """grad_stats(method="vmap") over the split batch ``mb`` (the rank's
    rows of each group under a mesh)."""
    from repro_torch.kernels import ops as kops

    layout = params.layout
    gfn = torch.func.grad_and_value(loss_fn, has_aux=True)
    grads, (loss, aux) = torch.func.vmap(gfn, in_dims=(None, 0))(params.detached_tree(), mb)
    if fused:
        sh = None if plan is None else plan.shard(layout)
        gstack = params.pack_stack(grads, k)
        del grads
        if plan is not None:  # the rank's rows of the ranks' mean stack
            gstack = plan.reduce_stack_rows(gstack, layout)
        if squares:
            stats = kops.vmap_moments_flat(gstack, k, layout, plan)
        else:
            stats = GradStats(mean=FlatBuffer(gstack.mean(dim=0), layout, sh), sq_mean=None, k=k)
    elif mesh is not None:  # the whole mean stack on every rank, then tree means
        gstack = mesh.all_reduce_(params.pack_stack(grads, k)).mul_(inv_k(mesh.size))
        del grads
        stats = GradStats(
            mean=layout.unpack(gstack.mean(dim=0)),
            sq_mean=layout.unpack(gstack.square().mean(dim=0)) if squares else None,
            k=k)
    else:
        stats = GradStats(
            mean=stack_groups(tree_map(lambda g: g.mean(dim=0), grads)),
            sq_mean=stack_groups(tree_map(lambda g: g.square().mean(dim=0), grads))
            if squares else None,
            k=k)
    loss, aux = loss.detach().mean(), {n: v.detach().mean(dim=0) for n, v in aux.items()}
    if mesh is not None:
        loss, aux = mean_over_ranks(mesh, loss, aux)
    return loss, aux, stats


def grad_only(loss_fn: Callable, params: FlatParams, batch: Dict, spmd=None):
    """(loss, aux, gradient) of one backward over the whole batch (the
    baseline optimizers; no moment of squares).  The gradient is the
    stacked tree of views of ``params.grad``.  Under a mesh of W > 1 ranks
    (``spmd``) each rank takes its rows with the global denominator, one
    all-reduce of the flat gradient x 1/W gives every rank the whole
    batch's, and the loss and aux are the ranks' means."""
    mesh = _mesh_of(spmd)
    if mesh is not None:
        one = _rank_groups(loss_fn, {name: x[None] for name, x in batch.items()}, mesh)
        batch = {name: x[0] for name, x in one.items()}
    params.zero_grad()
    loss, aux = loss_fn(params.tree, batch)
    loss.backward()
    loss, aux = loss.detach(), {n: v.detach() for n, v in aux.items()}
    if mesh is not None:
        mesh.all_reduce_(params.grad).mul_(inv_k(mesh.size))
        loss, aux = mean_over_ranks(mesh, loss, aux)
    return loss, aux, params.stacked("grad")
