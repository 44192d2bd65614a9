"""Placement of the model's weights on a (data, model) grid of ranks.

The port's counterpart of the reference's ``param_shardings`` plus GSPMD:
the reference places each parameter leaf by its spec (sharding/rules.py)
and the compiler keeps the single-device semantics; here each rank holds
its block of every leaf and the model gathers what it computes with, by
hand, with autograd's adjoint collective in the backward.

Geometry.  A spec splits each dim over the product of its entry's axes (the
first axis major); the rank at coordinates c holds one block per dim
(``block_slices``).  ``shard_params`` takes a rank's blocks of a whole
tree, ``assemble_params`` puts the blocks of every rank back together (no
collective), and core/layout.py::GridShard.gather is the collective form
(one all-gather of the ranks' local buffers; the checkpoint and the tests
use it).

Gather on use.  ``gather(x, spec, mesh, axes, same)`` is an autograd
Function: its forward all-gathers the block ``x`` over ``axes`` (the
block's other axes stay split), its backward is the adjoint, which leaves
the weight's gradient in the rank's block:

  * the data axis always SUMS: its ranks took different rows of the batch;
  * the model axis SUMS where its ranks computed disjoint parts with the
    gathered weight (a row-parallel product, each rank its own input rows),
    and takes the rank's own block where they computed the same values
    from the same inputs (``same``: replicated compute, as for norms), so
    that no replicated contribution is counted M times;
  * an axis over which the leaf is replicated and whose ranks sum has its
    share all-reduced.

The gathers and the tensor-parallel operators below are autograd
Functions with ``setup_context`` and explicit vmap rules, so that the vmap
stats method's ``torch.func.vmap(grad(...))`` runs through them: the
weights enter unbatched (each gathered once for all k groups), and a
batched cotangent or activation goes through ONE collective of the stacked
tensor, its batch dim moved clear of the gathered dim.  Under
``Placement.deferred(sink)`` (the data-axis GSNR source) a gather's
backward leaves the data axis's sum undone: each rank adds its model-axis
block of the gradient, whole over the data axis, to a ``PayloadSink``.

``Placement`` is the model's side of a GridMesh: which leaves a rank
gathers whole ("rep", computed replicated), over the data axis only
("col": column-parallel, the rank's heads, d_ff columns, RG-LRU channels,
vocab rows, or experts) or whole for its input rows ("row": row-parallel;
also a replicated 1-D leaf the model ranks read in parts, the RG-LRU's
``a_log``, whose gradient the model axis sums); and the Megatron operators
around the tensor-parallel regions: ``enter`` (identity forward,
all-reduce of the input's gradient over the model axis) and the row
product's sum of the f32 partial products over the model axis before the
cast (``reduce``: all-reduce forward, identity backward).  Where the model
axis cannot split the compute (a head or vocab count it does not divide),
the weights are gathered whole and the compute is replicated; the mLSTM
and sLSTM blocks and the image projection always run replicated.  A mixture
of experts (models/moe.py::apply_moe_grid) follows the reference's expert
rule (``moe_mode``): the rank's experts where the model axis splits E, each
expert's d_ff columns where it splits d_ff (``expert_col_product``,
``expert_row_product``), and the data ranks' expert counts cross the data
axis in one all-gather with no gradient (``data_counts``).

Serving (models/transformer.py::prefill_grid, decode_step_grid; no
autograd).  The caches are placed by the reference's cache rule
(models/transformer.py::cache_specs): a paged cache's slots split over
the model axis (``cache_slots``), every kv head on each rank, so the fresh
k and v of a head-split attention and a decode step's q are all-gathered
over the model axis (``gather_heads``: gloo has no all-to-all); each model
rank's decode over its slots is merged by the log-sum-exps the decode
kernel returns (``merge_partials``, ``lse_merge``); the embedding and the
logits come from the rank's vocab blocks without gathering the table or
the head (``serve_embed``, ``serve_logits``), and the whole vocab's logits
of the rank's rows are all-gathered over the model axis
(``whole_logits``).  A decode loop stops when no rank of the grid has a
live row (``any_rank``).

Precision.  Every tensor-parallel GEMM takes its operands in the compute
dtype, as one card's does.  Its result is f32 only where the model axis
sums partials across the ranks: the row product's forward and the column
products' input gradient (``mm_f32``: f32 accumulation rounded once to
f32), so each such sum is rounded to the compute dtype once, as one card's
single GEMM is.  The column products' forward and every weight gradient
stay in the compute dtype.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.rules import Rules, Spec, entry_axes

NEG_INF = -1e30  # a masked score, the lse of a lane that reaches no slot

# The RG-LRU's leaves whose last dim the model axis splits into the rank's
# channels (models/recurrent.py::apply_rglru); its w_out is row-parallel.
REC_COLS = ("w_y", "w_rg_a", "w_rg_x")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _entry_index(entry, coords: Dict[str, int], sizes: Dict[str, int],
                 only: Optional[Sequence[str]] = None) -> Tuple[int, int]:
    """(block index, block count) of one spec entry at ``coords``, over its
    axes (those in ``only``, when given), the first axis major."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        if only is not None and a not in only:
            continue
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def shard_shape(shape: Sequence[int], spec: Spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The block shape of a leaf of ``shape`` under ``spec``."""
    out = []
    for d, e in zip(shape, spec):
        n = _entry_index(e, {a: 0 for a in entry_axes(e)}, sizes)[1]
        if d % n:
            raise ValueError(f"dim {d} does not split over {e} ({n} blocks)")
        out.append(d // n)
    return tuple(out)


def block_slices(block: Sequence[int], spec: Spec, coords: Dict[str, int],
                 sizes: Dict[str, int], only: Optional[Sequence[str]] = None):
    """The slices of the rank at ``coords``'s block (of shape ``block``)
    inside the leaf, or inside the leaf gathered over the axes ``only``."""
    out = []
    for n, e in zip(block, spec):
        i, _ = _entry_index(e, coords, sizes, only)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def _coords_of(mesh) -> Tuple[Dict[str, int], Dict[str, int]]:
    return dict(mesh.coords), dict(mesh.shape)


def shard_params(tree, specs, mesh, device=None):
    """This rank's block of every leaf of ``tree`` (a tree of tensors or
    numpy arrays, ``specs`` a tree of Specs of the same structure), as new
    contiguous tensors (on ``device``, by default the leaf's).  ``mesh``
    is a GridMesh or anything with its ``coords`` and ``shape``."""
    coords, sizes = _coords_of(mesh)

    def one(x, spec):
        x = torch.as_tensor(x)
        blk = x[block_slices(shard_shape(x.shape, spec, sizes), spec, coords, sizes)]
        return blk.to(device if device is not None else blk.device, copy=True).contiguous()

    return _map2(one, tree, specs)


def assemble_params(blocks_by_rank: Sequence, specs, mesh_shape: Dict[str, int],
                    coords_by_rank: Sequence[Dict[str, int]]):
    """The whole leaves from every rank's blocks (``shard_params``' inverse
    with the ranks in one process): ``blocks_by_rank[r]`` is rank r's tree,
    at ``coords_by_rank[r]``."""
    def one(spec, *blocks):
        shape = [n * _entry_index(e, {a: 0 for a in entry_axes(e)}, mesh_shape)[1]
                 for n, e in zip(blocks[0].shape, spec)]
        out = blocks[0].new_empty(shape)
        for blk, c in zip(blocks, coords_by_rank):
            out[block_slices(blk.shape, spec, c, mesh_shape)] = blk
        return out

    return _map2(lambda spec, *b: one(spec, *b), specs, *blocks_by_rank)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` (this rank's block) all-gathered over ``axes``: the leaf with
    the dims of those axes whole, the others still split (a new tensor; a
    collective over the ranks that differ from this one on ``axes``)."""
    axes = [a for a in mesh.axis_names if a in axes and a in spec.axes()]
    if not axes:
        return x
    parts = mesh.all_gather(x, axes)
    shape = [n * _entry_index(e, {a: 0 for a in mesh.axis_names}, mesh.shape, axes)[1]
             for n, e in zip(x.shape, spec)]
    out = x.new_empty(shape)
    for r, part in zip(mesh.members(axes), parts):
        out[block_slices(x.shape, spec, mesh.coords_of(r), mesh.shape, axes)] = part
    return out


def _adjoint(ct: torch.Tensor, block: Tuple[int, ...], spec: Spec, mesh, axes: Sequence[str],
             same: Sequence[str]) -> torch.Tensor:
    """The gradient of a rank's block from the cotangent ``ct`` of its
    gather over ``axes`` (the backward of ``gather``; module note)."""
    axes = [a for a in mesh.axis_names if a in axes and a in spec.axes()]
    summed = [a for a in axes if a not in same]
    members = mesh.members(summed) if summed else [mesh.rank]
    if summed:
        blocks = torch.stack([ct[block_slices(block, spec, mesh.coords_of(r), mesh.shape, axes)]
                              for r in members])
        g = mesh.reduce_scatter_(blocks, summed)
    else:
        g = ct[block_slices(block, spec, mesh.coords, mesh.shape, axes)].contiguous()
    rest = [a for a in mesh.axis_names if a not in same and a not in spec.axes()
            and mesh.shape[a] > 1]
    if rest:
        g = mesh.all_reduce_(g.contiguous(), rest)
    return g


def _payload_adjoint(ct: torch.Tensor, block: Tuple[int, ...], spec: Spec, mesh,
                     axes: Sequence[str], same: Sequence[str], dst: torch.Tensor) -> None:
    """``_adjoint`` with the data axis's sum deferred (``PayloadSink``):
    adds to ``dst`` (D, *block) the block of each data rank of this rank's
    model column, summed over the model axis as ``_adjoint`` sums it (the
    rank's own block in every slot where the leaf is not split over the
    data axis)."""
    dp, tp = mesh.axis_names
    axes = [a for a in mesh.axis_names if a in axes and a in spec.axes()]
    column = mesh.members(dp)

    def blocks(j: int) -> torch.Tensor:  # the column's data ranks' blocks at model index j
        return torch.stack([ct[block_slices(block, spec, {**mesh.coords_of(r), tp: j},
                                            mesh.shape, axes)] for r in column])

    if tp in axes and tp not in same:
        x = mesh.reduce_scatter_(torch.stack([blocks(j) for j in range(mesh.shape[tp])]), tp)
    else:
        x = blocks(mesh.coords[tp])
        if tp not in same and tp not in spec.axes() and mesh.shape[tp] > 1:
            x = mesh.all_reduce_(x.contiguous(), tp)
    dst.add_(x)


class PayloadSink:
    """Where the gathers' backward leaves the gradient of a rank's blocks
    with the data axis's sum deferred (the data-axis GSNR source on a grid,
    core/distributed.py): ``buf`` (D, rows, LANE) f32, whose slot d holds
    the blocks of data rank d of this rank's model column in the rank's
    local layout, each leaf block at the element offset its parameter has
    in ``data`` (the GridParams buffer the leaves are views of)."""

    def __init__(self, buf: torch.Tensor, data: torch.Tensor):
        self.buf, self.data = buf, data

    def view_for(self, x: torch.Tensor) -> torch.Tensor:
        """The (D, *x.shape) view of ``buf`` at the elements of ``x``, a
        contiguous view of ``data``."""
        if x.untyped_storage().data_ptr() != self.data.untyped_storage().data_ptr() \
                or not x.is_contiguous():
            raise ValueError("PayloadSink: the gathered block is not a view of the params")
        off = x.storage_offset() - self.data.storage_offset()
        d = self.buf.shape[0]
        return self.buf.view(d, -1)[:, off: off + x.numel()].view(d, *x.shape)


def _batched(spec: Spec) -> Spec:
    """``spec`` with a leading unsplit dim: a vmapped dim moved to the front
    stays whole through every gather and reduction."""
    return Spec(None, *spec)


# The autograd Functions below take their context in ``setup_context`` and
# carry an explicit ``vmap`` rule, so that ``torch.func.grad`` and ``vmap``
# (the vmap stats method, core/accumulate.py) run through them: a vmapped
# tensor moves its batch dim to the front and goes through ONE collective of
# the stacked tensor (an all-reduce commutes with the batch dim; a gather
# or a reduce-scatter along a spec dim keeps it out of that dim,
# ``_batched``).  A collective has no batching rule, so none is generated.


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, spec, mesh, axes, same, sink):
        out = gather_leaf(x, spec, mesh, axes)
        return out.view_as(out) if out is x else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, spec, mesh, axes, same, sink = inputs
        ctx.meta = (tuple(x.shape), spec, mesh, tuple(axes), tuple(same))
        ctx.dst = None if sink is None else sink.view_for(x)

    @staticmethod
    def backward(ctx, ct):
        block, spec, mesh, axes, same = ctx.meta
        if ctx.dst is not None:  # the data axis's sum deferred to the payload
            _payload_adjoint(ct, block, spec, mesh, axes, same, ctx.dst)
            return None, None, None, None, None, None
        return _Adjoint.apply(ct, block, spec, mesh, axes, same), None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, spec, mesh, axes, same, sink):
        if sink is not None:
            raise NotImplementedError("a payload sink under torch.func.vmap")
        return _Gather.apply(x.movedim(in_dims[0], 0), _batched(spec), mesh, axes, same,
                             None), 0


class _Adjoint(torch.autograd.Function):
    """``_adjoint`` as a Function of its own, so that a batched cotangent
    (the vmap stats method's k groups) reduces in one collective.  First
    order only."""

    @staticmethod
    def forward(ct, block, spec, mesh, axes, same):
        return _adjoint(ct, block, spec, mesh, axes, same)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("the gathers' adjoint is first order only")

    @staticmethod
    def vmap(info, in_dims, ct, block, spec, mesh, axes, same):
        return _Adjoint.apply(ct.movedim(in_dims[0], 0), (info.batch_size, *block),
                              _batched(spec), mesh, axes, same), 0


def gather(x: torch.Tensor, spec: Spec, mesh, axes: Sequence[str],
           same: Sequence[str] = (), sink: Optional[PayloadSink] = None) -> torch.Tensor:
    """``gather_leaf`` with autograd's adjoint in the backward (module
    note): ``same`` lists the axes whose ranks compute the same cotangent.
    With a ``sink`` the backward defers the data axis's sum and adds the
    data ranks' blocks to the sink instead (``_payload_adjoint``); the
    block then takes no gradient of its own."""
    return _Gather.apply(x, spec, mesh, tuple(axes), tuple(same), sink)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(x, mesh, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.meta = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return _Reduce.apply(g, mesh, axis, "sum"), None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis):
        return _Enter.apply(x, mesh, axis), in_dims[0]


class _Reduce(torch.autograd.Function):
    """All-reduce (sum, or ``op="max"``) over the model axis forward;
    identity backward."""

    @staticmethod
    def forward(x, mesh, axis, op):
        return mesh.all_reduce_(x.contiguous().clone(), axis, op=op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, op):
        return _Reduce.apply(x, mesh, axis, op), in_dims[0]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., k), b (k, n)) as f32: operands in a lower
    precision multiply as they are and accumulate in f32, rounded once to
    f32 (``torch.mm``'s ``out_dtype`` on the card; on the CPU the f32
    product of the same operands); f32 operands multiply as they are."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _unbatched(in_dims, what: str) -> None:
    if in_dims[1] is not None:
        raise NotImplementedError(f"{what} of a vmapped weight: the weights enter the vmap "
                                  "stats method unbatched")


class _MmF32(torch.autograd.Function):
    """``mm_f32`` whose vmap rule takes the rows of every vmapped group in
    one product (``a`` batched, ``b`` not).  First order only."""

    @staticmethod
    def forward(a, b):
        return mm_f32(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("mm_f32 in a backward is first order only")

    @staticmethod
    def vmap(info, in_dims, a, b):
        _unbatched(in_dims, "mm_f32")
        return _MmF32.apply(a.movedim(in_dims[0], 0), b), 0


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _ColProduct(torch.autograd.Function):
    """``x @ w`` of an entered f32 ``x`` (values of ``w``'s dtype) and the
    rank's columns ``w`` in the compute dtype: the product in that dtype
    forward, as one card takes it; backward the input gradient's partial
    product in f32 (``enter`` sums it over the model axis), the weight's in
    the compute dtype (from ``x`` cast again: a Function under
    ``torch.func`` saves only its inputs and outputs)."""

    @staticmethod
    def forward(x, w):
        return x.to(w.dtype) @ w

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return _MmF32.apply(dy, w.T), _rows(x.to(w.dtype)).T @ _rows(dy)

    @staticmethod
    def vmap(info, in_dims, x, w):
        _unbatched(in_dims, "a column product")
        return _ColProduct.apply(x.movedim(in_dims[0], 0), w), 0


class _RowProduct(torch.autograd.Function):
    """``h @ w`` of the rank's input columns ``h`` and its rows ``w`` of a
    row-parallel weight, both in the compute dtype: the f32 partial product
    forward (summed over the model axis before the cast); backward in the
    compute dtype, as one card's product."""

    @staticmethod
    def forward(h, w):
        return mm_f32(h, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dy = dy.to(h.dtype)
        return dy @ w.T, _rows(h).T @ _rows(dy)

    @staticmethod
    def vmap(info, in_dims, h, w):
        _unbatched(in_dims, "a row product")
        return _RowProduct.apply(h.movedim(in_dims[0], 0), w), 0


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` as f32, ``mm_f32``'s batched form (one product
    per expert)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if not a.is_cuda:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def _experts_batched(t: torch.Tensor, dim: int) -> Tuple[torch.Tensor, int, int]:
    """A vmapped (E, C, n) operand with its batch at ``dim`` as (E, B C, n),
    with E and C."""
    t = t.movedim(dim, 1)
    return t.reshape(t.shape[0], -1, t.shape[-1]), t.shape[0], t.shape[2]


class _BmmColProduct(torch.autograd.Function):
    """``_ColProduct`` per expert: an entered f32 buffer ``x`` (E, C, d)
    and the rank's columns ``w`` (E, d, n) in the compute dtype; forward
    in that dtype, the input gradient's partial product in f32 (``enter``
    sums it over the model axis), the weight's in the compute dtype."""

    @staticmethod
    def forward(x, w):
        return torch.bmm(x.to(w.dtype), w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return bmm_f32(dy, w.transpose(1, 2)), torch.bmm(x.to(w.dtype).transpose(1, 2), dy)

    @staticmethod
    def vmap(info, in_dims, x, w):
        _unbatched(in_dims, "an expert column product")
        x, e, c = _experts_batched(x, in_dims[0])
        y = _BmmColProduct.apply(x, w)
        return y.reshape(e, info.batch_size, c, y.shape[-1]), 1


class _BmmRowProduct(torch.autograd.Function):
    """``_RowProduct`` per expert: the rank's d_ff columns ``h`` (E, C,
    F/M) and its rows ``w`` (E, F/M, d) of every expert's down projection,
    both in the compute dtype: the f32 partial product forward (summed over
    the model axis with the combine, models/moe.py), backward in the
    compute dtype."""

    @staticmethod
    def forward(h, w):
        return bmm_f32(h, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dy = dy.to(h.dtype)
        return torch.bmm(dy, w.transpose(1, 2)), torch.bmm(h.transpose(1, 2), dy)

    @staticmethod
    def vmap(info, in_dims, h, w):
        _unbatched(in_dims, "an expert row product")
        h, e, c = _experts_batched(h, in_dims[0])
        y = _BmmRowProduct.apply(h, w)
        return y.reshape(e, info.batch_size, c, y.shape[-1]), 1


class _GatherCounts(torch.autograd.Function):
    """The data ranks' integer counts (..., E), all-gathered over the data
    axis into (D, ..., E), rank order; no gradient.  Under vmap the stacked
    counts of every group go through one all-gather."""

    @staticmethod
    def forward(c, mesh, axis):
        return torch.stack(mesh.all_gather(c, axis))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None

    @staticmethod
    def vmap(info, in_dims, c, mesh, axis):
        return _GatherCounts.apply(c.movedim(in_dims[0], 0), mesh, axis), 1


def lse_merge(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """Attention outputs over disjoint slot ranges merged into the output
    over their union, in f32: o = sum_j e^(lse_j - M) o_j / sum_j
    e^(lse_j - M), M = max_j lse_j (outs (B, L, H, D), lses (B, L, H)).  A
    range that holds nothing a lane reaches (lse NEG_INF) has weight
    exactly 0, and a lane no range reaches gives exactly 0."""
    lse = torch.stack(list(lses))
    live = lse > NEG_INF / 2
    mx = torch.where(live, lse, -float("inf")).amax(dim=0)
    w = torch.where(live, torch.exp(lse - torch.where(live.any(0), mx, 0.0)), 0.0)
    num = sum(wj[..., None] * oj.float() for wj, oj in zip(w, outs))
    den = w.sum(dim=0)[..., None]
    return torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)


def _map2(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [_map2(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# the model's side
# ---------------------------------------------------------------------------


def group_path(path: str, stacked: bool) -> Optional[str]:
    """The path inside a layer group of a reference path (``groups/pos0/
    attn/wq`` when the groups are stacked, ``groups/0/pos0/attn/wq``
    otherwise), or None for a leaf outside the groups."""
    if not path.startswith("groups/"):
        return None
    rest = path[len("groups/"):]
    return rest if stacked else rest.split("/", 1)[1]


class Placement:
    """How the transformer computes on a GridMesh (module note).

    ``specs`` maps each reference path of the stacked tree to its Spec and
    ``shapes`` to its whole shape.  ``attn_tp`` / ``xattn_tp`` / ``mlp_tp``
    / ``rec_tp`` / ``vocab_tp`` say whether the model axis splits the
    self-attention heads (the encoder's too), the cross-attention heads, the
    MLP's d_ff (a shared expert's too), the RG-LRU's channels and the vocab,
    ``moe_mode`` how it splits the experts (None without MoE); ``role(path)``
    is "col", "row" or "rep" for each leaf.

    Two modes a step sets around one forward and backward: ``deferred(sink)``
    (the data-axis GSNR source) hands every gather a ``PayloadSink``, and
    ``without_remat()`` (the vmap stats method) runs the layer groups of
    models/transformer.py::forward_grid without recomputation."""

    def __init__(self, model_cfg, rules: Rules, mesh, specs: Dict[str, Spec],
                 shapes: Dict[str, Tuple[int, ...]]):
        self.cfg, self.rules, self.mesh = model_cfg, rules, mesh
        self.specs, self.shapes = specs, shapes
        self.tp, self.dp = rules.tp_axis, rules.dp_axis
        self.m, self.j = mesh.shape[self.tp], mesh.coords[self.tp]
        cfg = model_cfg
        self.stacked = cfg.n_groups() > 1

        def last_is_tp(names, parent=None):
            """Some leaf is named one of ``names`` (under ``parent``), and
            every such leaf's last dim is over the model axis."""
            found = [spec for p, spec in specs.items() if p.split("/")[-1] in names
                     and (parent is None or p.split("/")[-2] == parent)]
            return bool(found) and all(spec[-1] == self.tp for spec in found)

        m = self.m
        heads = m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
        self.attn_tp = heads and last_is_tp(("wq", "wk", "wv"), "attn")
        self.xattn_tp = heads and last_is_tp(("wq", "wk", "wv"), "xattn")
        # a block without an MLP (xLSTM: d_ff == 0) splits no d_ff
        self.mlp_tp = m > 1 and cfg.d_ff > 0 and cfg.d_ff % m == 0 and last_is_tp(("wi", "wg"))
        self.rec_tp = m > 1 and cfg.d_model % m == 0 and last_is_tp(REC_COLS, "rec")
        table = specs["embed/embed"]
        self.vocab_tp = m > 1 and table[0] == self.tp and (
            cfg.tie_embeddings or specs["head"][-1] == self.tp)
        self.moe_mode = self._moe_mode() if cfg.moe is not None else None
        self.sink: Optional[PayloadSink] = None
        self.remat = True

    def _moe_mode(self) -> str:
        """How the model axis splits the experts (the reference's expert
        rule): "ep" when it splits the expert dim (the rank's E/M experts),
        "tp" when it splits each expert's d_ff (the rank's columns of every
        expert), "rep" when it splits neither (every expert whole)."""
        def specs_of(name):
            return [spec for p, spec in self.specs.items() if p.split("/")[-1] == name]

        if all(spec[-3] == self.tp for spec in specs_of("expert_wi")):
            return "ep"
        if all(spec[-1] == self.tp for n in ("expert_wi", "expert_wg") for spec in specs_of(n)):
            return "tp"
        return "rep"

    @contextlib.contextmanager
    def deferred(self, sink: PayloadSink):
        """Gathers made inside the block defer the data axis's sum of their
        backward to ``sink`` (``_payload_adjoint``)."""
        self.sink = sink
        try:
            yield
        finally:
            self.sink = None

    @contextlib.contextmanager
    def without_remat(self):
        """The grid's forward inside the block keeps its activations:
        ``torch.func`` cannot run through the remat Function, whose backward
        reruns the group under plain autograd."""
        self.remat = False
        try:
            yield
        finally:
            self.remat = True

    # -- roles and gathers ---------------------------------------------------

    def role(self, path: str) -> str:
        *_, parent, name = ("",) + tuple(path.split("/"))
        if name in ("expert_wi", "expert_wg", "expert_wd"):
            if self.moe_mode == "ep" or (self.moe_mode == "tp" and name != "expert_wd"):
                return "col"
            return "row" if self.moe_mode == "tp" else "rep"
        if parent in ("attn", "xattn"):
            if self.attn_tp if parent == "attn" else self.xattn_tp:
                return "row" if name == "wo" else "col"
            return "rep"
        if self.mlp_tp and name in ("wi", "wg"):
            return "col"
        if self.mlp_tp and name == "wd":
            return "row"
        if parent == "rec" and self.rec_tp:
            # a_log: replicated, read in parts by the model ranks, so its
            # gradient is summed over the model axis as a row weight's
            return "col" if name in REC_COLS else "row" if name in ("w_out", "a_log") else "rep"
        if self.vocab_tp and path in ("embed/embed", "head"):
            return "col"
        return "rep"

    def use(self, x: torch.Tensor, path: str, dims: int = 0) -> torch.Tensor:
        """The weight the rank computes with, gathered from its block ``x``
        of ``path`` (``dims`` leading dims of the leaf's spec dropped: 1
        for a layer group's slice of a stacked leaf)."""
        spec = Spec(*self.specs[path][dims:])
        role = self.role(path)
        axes = [a for a in spec.axes() if not (role == "col" and a == self.tp)]
        same = (self.tp,) if role == "rep" else ()
        if not axes and not any(self.mesh.shape[a] > 1 for a in self.mesh.axis_names
                                if a not in same and a not in spec.axes()):
            return x
        return gather(x, spec, self.mesh, axes, same, self.sink)

    def group_dims(self, path: str) -> int:
        """1 when a layer group takes the ``[g]`` slice of the rank's block
        of ``path`` (the stacked leaf's layer dim is not split), 0 when the
        leaf is gathered whole (a leaf outside the groups, an unstacked
        group's leaf, or a stacked one whose layer dim is split)."""
        if not (self.stacked and path.startswith("groups/")):
            return 0
        return 1 if self.specs[path][0] is None else 0

    # -- the tensor-parallel regions -----------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel region, as f32: the f32 partials of
        its gradient (``col_product``'s) are summed over the model axis,
        then cast once."""
        return _Enter.apply(x.float(), self.mesh, self.tp)

    def col_product(self, x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
        """``x @ w`` for an entered ``x`` and the rank's columns ``w``
        rounded to ``dtype`` (as the single-device product rounds the
        weight), in ``dtype`` (``_ColProduct``)."""
        return _ColProduct.apply(x, w.to(dtype))

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or its maximum, ``op="max"``; take no gradient
        through that) over the model axis; identity backward."""
        return _Reduce.apply(x, self.mesh, self.tp, op)

    def own(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The rank's block of ``x``'s ``dim`` cut in M equal parts (its
        channels of a tensor the model ranks hold whole)."""
        n = x.shape[dim] // self.m
        return x.narrow(dim, self.j * n, n)

    def row_product(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h @ w`` of the rank's input columns ``h`` (..., F/M) and the
        whole gathered ``w`` (F, d): the f32 partial product of the rank's
        rows of w (rounded to h's dtype as the single-device product rounds
        the weight), summed over the model axis in f32, cast once."""
        return self.reduce(_RowProduct.apply(h, self.own(w, 0).to(h.dtype))).to(h.dtype)

    # -- the mixture of experts (models/moe.py::apply_moe_grid) --------------

    @property
    def data_index(self) -> int:
        return self.mesh.coords[self.dp]

    def data_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Every data rank's integer counts (E,) as (D, E), rank order: one
        all-gather over the data axis, no gradient."""
        return _GatherCounts.apply(counts, self.mesh, self.dp)

    def expert_col_product(self, buf: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
        """``buf @ w`` per expert for an entered f32 dispatch buffer (E, C,
        d) and the rank's columns ``w`` (E, d, n) rounded to ``dtype``, in
        ``dtype`` (``_BmmColProduct``)."""
        return _BmmColProduct.apply(buf, w.to(dtype))

    def expert_row_product(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The f32 partial ``h @ w`` per expert of the rank's d_ff columns
        ``h`` (E, C, F/M) and the whole gathered ``w`` (E, F, d) narrowed to
        the rank's rows, rounded to h's dtype; not yet summed over the model
        axis (the combine sums it, models/moe.py)."""
        f = w.shape[1] // self.m
        return _BmmRowProduct.apply(h, w.narrow(1, self.j * f, f).to(h.dtype))

    # -- sharded serving (models/attention.py, transformer.py::forward_grid) --

    def cache_slots(self, spec: Spec, slots: int) -> Optional[Tuple[int, int]]:
        """(the first slot of the rank's block, ``slots``) of a paged cache
        leaf (B, C, ...) of ``slots`` slots placed by ``spec`` (the
        reference's cache rule, models/transformer.py::cache_specs), or
        None when the model axis leaves the slots whole.  The batch must be
        split over the data axis and the slots over the model axis or not
        at all:
        another placement (the rule's by-size search taking another dim for
        the batch, or a batch the data axis does not divide) raises."""
        self._check_rows(spec)
        seq = spec[1]
        if seq is None:
            return None
        if seq != self.tp:
            raise NotImplementedError(f"cache spec {spec}: slots over {seq!r}, not the model "
                                      "axis alone")
        return self.j * (slots // self.m), slots

    def check_rec_cache(self, specs: Dict) -> None:
        """Raise unless the RG-LRU cache's specs are the blocks its serving
        path holds: ``h`` (B, D) the rank's channels exactly where
        ``rec_tp`` splits them, ``conv`` (B, 3, D) whole over the model
        axis (ξ is computed whole)."""
        h, conv = specs["h"], specs["conv"]
        self._check_rows(h)
        self._check_rows(conv)
        if (h[1] == self.tp) != self.rec_tp or conv[1:] != (None, None):
            raise NotImplementedError(f"an RG-LRU cache placed as h {h}, conv {conv} with the "
                                      f"channels {'split' if self.rec_tp else 'whole'}")

    def _check_rows(self, spec: Spec) -> None:
        """Raise unless a cache leaf's spec splits its dim 0, the rows, over
        the data axis, as the serving grid splits the batch."""
        if spec[0] != self.dp:
            raise ValueError(f"cache spec {spec}: the serving grid splits the rows over "
                             f"{self.dp!r} (is the batch a size another dim 1 has, or one "
                             "the data axis does not divide?)")

    def gather_heads(self, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each of ``ts`` (B, S, heads of the rank, D) with every rank's
        heads (dim 2), rank order: one all-gather over the model axis of
        them side by side, and concatenations (no all-to-all: gloo has
        none).  No gradient."""
        if self.m == 1:
            return ts
        sizes = [t.shape[2] for t in ts]
        parts = self.mesh.all_gather(torch.cat(ts, dim=2).contiguous(), self.tp)
        split = [p.split(sizes, dim=2) for p in parts]
        return tuple(torch.cat([sp[i] for sp in split], dim=2) for i in range(len(ts)))

    def merge_partials(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The attention over the whole cache from each model rank's over
        its slots: every rank's out (B, L, H, D) and lse (B, L, H) f32,
        all-gathered over the model axis side by side, merged by
        ``lse_merge``."""
        parts = self.mesh.all_gather(torch.cat([out.float(), lse[..., None]], dim=-1), self.tp)
        return lse_merge([p[..., :-1] for p in parts], [p[..., -1] for p in parts]).to(out.dtype)

    @property
    def vocab_blocks(self) -> bool:
        """The vocab split over the model axis and d_model over the data
        axis in the embedding table (and the head): serving then looks up
        the embedding and forms the logits from the rank's blocks
        (``serve_embed``, ``serve_logits``), where a train step gathers
        the table over the data axis."""
        dp_tp, tp_dp = (self.tp, self.dp), (self.dp, self.tp)
        return self.vocab_tp and tuple(self.specs["embed/embed"]) == dp_tp and (
            self.cfg.tie_embeddings or tuple(self.specs["head"]) == tp_dp)

    def serve_embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The embedding of the rank's rows (B, S) from its block of the
        table (V/M rows, d/D columns; ``vocab_blocks``), without gathering
        the table: the data ranks' tokens all-gathered, each rank's rows of
        them looked up in its block (zero where the token falls outside
        it), summed over the model axis, and the data ranks' column blocks
        all-gathered onto the rank's rows."""
        b = tokens.shape[0]
        every = torch.cat(self.mesh.all_gather(tokens.contiguous(), self.dp))
        local = every.long() - self.vocab_offset()
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(inside, local, 0)].to(dtype)
        part = self.reduce(torch.where(inside[..., None], rows, 0))
        own = slice(self.data_index * b, (self.data_index + 1) * b)
        return torch.cat([c[own] for c in self.mesh.all_gather(part, self.dp)], dim=-1)

    def serve_logits(self, x: torch.Tensor, weight: torch.Tensor, tied: bool) -> torch.Tensor:
        """f32 logits of the rank's rows and vocab columns from its block of
        the head (d/D rows, V/M columns) or of a tied table, without
        gathering it (``vocab_blocks``): every data rank's rows of ``x``
        all-gathered, their product with the rank's block over its d/D
        columns of them, summed over the data axis onto each data rank's
        rows (one reduce-scatter)."""
        d = self.mesh.shape[self.dp]
        b = x.shape[0]
        w = weight.float().T if tied else weight.float()
        every = torch.cat(self.mesh.all_gather(x.contiguous(), self.dp))
        n = w.shape[0]
        cols = every[..., self.data_index * n:(self.data_index + 1) * n].float()
        part = (cols @ w).reshape(d, b, *x.shape[1:-1], w.shape[1])
        return self.mesh.reduce_scatter_(part, self.dp)

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocab's logits of the rank's rows: its vocab columns
        all-gathered over the model axis where the placement splits the
        vocab, else ``logits``."""
        if not self.vocab_tp:
            return logits
        return torch.cat(self.mesh.all_gather(logits.contiguous(), self.tp), dim=-1)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on some rank of the grid (one all-reduce:
        a decision every rank takes alike, as a stop of the decode loop
        must be)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.mesh.device)
        return float(self.mesh.all_reduce_(t, op="max")) > 0

    def vocab_offset(self) -> int:
        return self.j * (self.cfg.vocab_size // self.m)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The embedding lookup: with the vocab split, the rank's rows
        looked up where the token falls in them (zero elsewhere), summed over
        the model axis; else the plain lookup of the whole table."""
        if not self.vocab_tp:
            return table.to(dtype)[tokens]
        v = table.shape[0]
        local = tokens.long() - self.vocab_offset()
        inside = (local >= 0) & (local < v)
        rows = table.to(dtype)[torch.where(inside, local, 0)]
        return self.reduce(torch.where(inside[..., None], rows, 0))

    def logits(self, x: torch.Tensor, weight: torch.Tensor, tied: bool) -> torch.Tensor:
        """f32 logits: the rank's vocab columns when the vocab is split
        (``x`` entered first), else the whole vocab."""
        w = weight.float().T if tied else weight.float()
        if not self.vocab_tp:
            return x.float() @ w
        return self.enter(x) @ w


def held_elements(shapes: Dict[str, Tuple[int, ...]], specs: Dict[str, Spec],
                  sizes: Dict[str, int]) -> int:
    """Elements a rank holds: the sum of its spec block sizes."""
    return int(sum(np.prod(shard_shape(shapes[p], specs[p], sizes), dtype=np.int64)
                   for p in shapes))
