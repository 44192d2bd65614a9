"""Device-wise GSNR statistics: the paper's Algorithm 1 over data-parallel
ranks.

Port of ``repro/core/distributed.py::device_grad_stats_fn``.  Each rank of a
``launch/mesh.py::DataMesh`` holds the whole parameter set, takes ONE
backward over its rows of the global batch (data/pipeline.py::shard_batch)
and contributes its gradient g_d to the moments, so k = W, the number of
ranks.  The paper all-reduces the per-device means and their squares with
two collectives; here:

  * the flat path (the plan's ``stats`` subsystem fused): one kernel
    (kernels/flat_stats.py::flat_pack_square, K11) builds the (2, n_rows,
    128) payload [g; g^2] from one read of the flat gradient, ONE all-reduce
    sums it, and mean, sq_mean are views of the reduced payload;
  * the tree path (reference plan): the per-leaf [g; g^2] stack of the
    reference's stacked tree, one all-reduce over it;
  * ``fused=False``: the paper's two-collective schedule, g then g^2.

The sums are divided by W as the microbatch finalize divides by k (times
the f32 1/W), so the statistics are those of k = W microbatch groups of the
same rows (property-tested against the reference's ``grad_stats``).  The
loss and its aux metrics are averaged across the ranks the same way.

``with_noise_terms`` also returns the two squared norms the noise-scale
estimator consumes (core/noise_scale.py), [|G_big|^2, |G_small|^2], summed
from the already-reduced moments, which every rank holds alike: no further
collective and no kernel.

On a GridMesh (``spmd`` a backend.GridSpmd, the weights' FSDP+TP
sharding) k = D, the data axis's size: data rank d takes its rows and g_d
is its whole gradient of them.  The gathers' backward would sum the data
ranks' gradients before anyone could square them, so the step runs it with
the data axis's sum deferred (sharding/placement.py::PayloadSink): the
model-axis sums (the replicated compute's own block, the row products'
reduce-scatters) still happen, and each rank keeps its model-axis block of
every leaf whole over the data axis, one (D, rows, 128) f32 buffer in its
local layout (slot d: data rank d's blocks).  K11 builds [g; g^2] of it in
one launch, and ONE reduce-scatter over the data axis sums the payload into
the rank's own blocks, x 1/D (a leaf not split over the data axis stands in
every slot, so it arrives summed whole); ``fused=False`` reduce-scatters
g and g^2 apart.  That is one whole-over-data gradient block per rank,
D times the rank's blocks for a leaf split over the data axis: the regime
of the reference's source, which keeps the params replicated.  The noise
terms are the reduced moments' sums, each leaf from its owners only (one
all-reduce of the per-leaf sums over the grid).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.backend import Backend, GridSpmd
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import LANE, FlatBuffer, FlatParams, tree_map
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels.flat_stats import flat_pack_square, inv_k


def _concat(tree) -> torch.Tensor:
    """The leaves of ``tree`` in ``tree_map`` order, flattened into one."""
    leaves = []
    tree_map(leaves.append, tree)
    return torch.cat([x.reshape(-1) for x in leaves])


def _split_like(tree, buf: torch.Tensor):
    """Views of ``buf`` (a ``_concat`` of a tree like ``tree``) in the
    leaf shapes of ``tree``."""
    offset = 0

    def take(x):
        nonlocal offset
        offset += x.numel()
        return buf[offset - x.numel(): offset].view(x.shape)

    return tree_map(take, tree)


def mean_over_ranks(mesh, loss: torch.Tensor, aux: Dict) -> Tuple[torch.Tensor, Dict]:
    """The ranks' mean of the loss and of each aux scalar (one all-reduce,
    times the f32 1/W)."""
    names = sorted(aux)
    scalars = torch.stack([loss.float()] + [aux[n].float() for n in names])
    scalars = mesh.all_reduce_(scalars).mul_(inv_k(mesh.size))
    return scalars[0], {n: scalars[i + 1] for i, n in enumerate(names)}


def device_grad_stats_fn(loss_fn: Callable, mesh, fused: bool = True,
                         backend: Optional[Backend] = None,
                         with_noise_terms: bool = False, spmd=None) -> Callable:
    """Returns f(params, batch) -> (loss, aux, GradStats) with k = mesh.size,
    or (loss, aux, GradStats, terms) with ``with_noise_terms``, where terms
    is the (2,) f32 tensor [|G_big|^2, |G_small|^2].

    ``params`` is the rank's FlatParams (the same on every rank); ``batch``
    the GLOBAL batch, of which the rank takes its rows; ``loss_fn(tree,
    batch) -> (loss, aux dict)`` as for core/accumulate.py::grad_stats.
    Every rank returns the same loss, aux and statistics: FlatBuffers on the
    fused ``stats`` plan, stacked trees on the reference plan.  With a
    sharding plan ``spmd`` (``Backend.shard(mesh)``) whose layout shards,
    the FlatBuffers are the rank's rows of the reduced moments, as the
    sharded update takes them."""
    bk = backend if backend is not None else Backend()
    if isinstance(spmd, GridSpmd):
        return _grid_stats_fn(loss_fn, spmd, fused, bk, with_noise_terms)
    k = mesh.size
    inv = inv_k(k)

    def fn(params: FlatParams, batch: Dict) -> Tuple[torch.Tensor, Dict, GradStats]:
        params.zero_grad()
        loss, aux = loss_fn(params.tree, shard_batch(batch, mesh))
        loss.backward()
        g = params.grad
        layout = params.layout
        if bk.fused("stats", params.device):
            if fused:  # one kernel, one collective; mean/sq are views
                payload = mesh.all_reduce_(flat_pack_square(g)).mul_(inv)
                mean, sq = payload[0], payload[1]
            else:  # the paper's two collectives over the flat carries
                mean = mesh.all_reduce_(g.clone()).mul_(inv)
                sq = mesh.all_reduce_(g * g).mul_(inv)
            if spmd is not None and spmd.supports(layout):
                sh = spmd.shard(layout)
                stats = GradStats(FlatBuffer(sh.local(mean), layout, sh),
                                  FlatBuffer(sh.local(sq), layout, sh), k)
            else:
                stats = GradStats(FlatBuffer(mean, layout), FlatBuffer(sq, layout), k)
        else:
            grads = params.stacked("grad")
            flat = _concat(grads)
            if fused:  # the per-leaf [g; g^2] stack, one collective
                payload = mesh.all_reduce_(torch.stack((flat, flat * flat))).mul_(inv)
                mean, sq = payload[0], payload[1]
            else:
                sq = mesh.all_reduce_(flat * flat).mul_(inv)
                mean = mesh.all_reduce_(flat).mul_(inv)
            stats = GradStats(_split_like(grads, mean), _split_like(grads, sq), k)
        out = (*mean_over_ranks(mesh, loss.detach(), {n: v.detach() for n, v in aux.items()}),
               stats)
        if with_noise_terms:
            # mean and sq are the reduced moments (whole buffers on the flat
            # path, zero tail padding) on every rank
            with torch.no_grad():
                m = mean.reshape(-1)
                out += (torch.stack([torch.dot(m, m), torch.sum(sq)]),)
        return out

    return fn


def _grid_stats_fn(loss_fn: Callable, spmd: GridSpmd, fused: bool, bk: Backend,
                   with_noise_terms: bool) -> Callable:
    """``device_grad_stats_fn`` on a GridMesh (module note): the moments are
    the rank's blocks (FlatBuffers of its GridShard on the fused plan,
    trees of its blocks on the reference plan)."""
    from repro_torch.sharding.placement import PayloadSink

    mesh, data = spmd.mesh, spmd.batch_mesh
    dp = mesh.axis_names[0]
    k = data.size
    inv = inv_k(k)

    def fn(params, batch: Dict):
        shard, layout = params.shard, params.layout
        flat = bk.fused("stats", params.device)
        sink = PayloadSink(torch.zeros((k, shard.rows, LANE), dtype=torch.float32,
                                       device=params.device), params.data)
        params.zero_grad()
        with loss_fn.placement.deferred(sink):
            loss, aux = loss_fn(params.tree, shard_batch(batch, data))
            loss.backward()
        g = sink.buf
        del sink
        if flat and fused:  # one kernel, one collective
            payload = flat_pack_square(g.view(-1, LANE)).view(2, k, shard.rows, LANE)
            red = mesh.reduce_scatter_(payload.transpose(0, 1), dp).mul_(inv)
        elif fused:  # the plain [g; g^2] stack, one collective
            red = mesh.reduce_scatter_(torch.stack((g, g * g), dim=1), dp).mul_(inv)
        else:  # the paper's two collectives
            red = torch.stack([mesh.reduce_scatter_(x, dp).mul_(inv) for x in (g, g * g)])
        del g
        mean, sq = red[0], red[1]
        if flat:
            stats = GradStats(FlatBuffer(mean, layout, shard), FlatBuffer(sq, layout, shard), k)
        else:
            unpack = params.local_layout.unpack
            stats = GradStats(unpack(mean), unpack(sq), k)
        out = (*mean_over_ranks(data, loss.detach(), {n: v.detach() for n, v in aux.items()}),
               stats)
        if with_noise_terms:
            with torch.no_grad():
                per = torch.stack([spmd.flat_leaf_sums(mean * mean), spmd.flat_leaf_sums(sq)])
                out += (spmd.leaf_totals(per).sum(dim=1).float(),)
        return out

    return fn
