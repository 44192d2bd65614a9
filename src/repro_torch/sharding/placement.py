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
collective), and ``gather_params`` is the collective form: every rank
gets the whole leaves (the checkpoint and the tests use it).

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

``Placement`` is the model's side of a GridMesh: which leaves a rank
gathers whole ("rep", computed replicated), over the data axis only
("col": column-parallel, the rank's heads, d_ff columns or vocab rows) or
whole for its input rows ("row": row-parallel); and the Megatron
operators around the tensor-parallel regions: ``enter`` (identity forward,
all-reduce of the input's gradient over the model axis) and the row
product's sum of the f32 partial products over the model axis before the
cast (``reduce``: all-reduce forward, identity backward).  Where the model
axis cannot split the compute (a head or vocab count it does not divide),
the weights are gathered whole and the compute is replicated.

Precision.  Every tensor-parallel GEMM takes its operands in the compute
dtype, as one card's does.  Its result is f32 only where the model axis
sums partials across the ranks: the row product's forward and the column
products' input gradient (``mm_f32``: f32 accumulation rounded once to
f32), so each such sum is rounded to the compute dtype once, as one card's
single GEMM is.  The column products' forward and every weight gradient
stay in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.rules import Rules, Spec, entry_axes

# The dense block kinds whose compute the model axis splits (attention + MLP).
TP_KINDS = ("attn", "swa", "local")
ROADMAP_REST = ("ROADMAP A9's remainder: expert parallelism, the RG-LRU/xLSTM/cross-attention "
                "blocks under a model axis, the data_axis source, vmap and the other optimizers "
                "on a grid, sharded serving and DLRM's tables")


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


def gather_params(shards, specs, mesh):
    """Every leaf whole on every rank (a collective per leaf)."""
    return _map2(lambda x, spec: gather_leaf(x, spec, mesh, mesh.axis_names), shards, specs)


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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, axes, same):
        ctx.meta = (tuple(x.shape), spec, mesh, tuple(axes), tuple(same))
        out = gather_leaf(x, spec, mesh, axes)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, ct):
        block, spec, mesh, axes, same = ctx.meta
        return _adjoint(ct, block, spec, mesh, axes, same), None, None, None, None


def gather(x: torch.Tensor, spec: Spec, mesh, axes: Sequence[str],
           same: Sequence[str] = ()) -> torch.Tensor:
    """``gather_leaf`` with autograd's adjoint in the backward (module
    note): ``same`` lists the axes whose ranks compute the same cotangent."""
    return _Gather.apply(x, spec, mesh, tuple(axes), tuple(same))


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return mesh.all_reduce_(g.contiguous().clone(), axis), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


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


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _ColProduct(torch.autograd.Function):
    """``x @ w`` of an entered f32 ``x`` (values of ``w``'s dtype) and the
    rank's columns ``w`` in the compute dtype: the product in that dtype
    forward, as one card takes it; backward the input gradient's partial
    product in f32 (``enter`` sums it over the model axis), the weight's in
    the compute dtype."""

    @staticmethod
    def forward(ctx, x, w):
        xc = x.to(w.dtype)
        ctx.save_for_backward(xc, w)
        return xc @ w

    @staticmethod
    def backward(ctx, dy):
        xc, w = ctx.saved_tensors
        return mm_f32(dy, w.T), _rows(xc).T @ _rows(dy)


class _RowProduct(torch.autograd.Function):
    """``h @ w`` of the rank's input columns ``h`` and its rows ``w`` of a
    row-parallel weight, both in the compute dtype: the f32 partial product
    forward (summed over the model axis before the cast); backward in the
    compute dtype, as one card's product."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return mm_f32(h, w)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dy = dy.to(h.dtype)
        return dy @ w.T, _rows(h).T @ _rows(dy)


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
    """How the dense transformer computes on a GridMesh (module note).

    ``specs`` maps each reference path of the stacked tree to its Spec and
    ``shapes`` to its whole shape.  ``attn_tp`` / ``mlp_tp`` / ``vocab_tp``
    say whether the model axis splits the attention heads, the MLP's d_ff
    and the vocab; ``role(path)`` is "col", "row" or "rep" for each leaf."""

    def __init__(self, model_cfg, rules: Rules, mesh, specs: Dict[str, Spec],
                 shapes: Dict[str, Tuple[int, ...]]):
        self.cfg, self.rules, self.mesh = model_cfg, rules, mesh
        self.specs, self.shapes = specs, shapes
        self.tp, self.dp = rules.tp_axis, rules.dp_axis
        self.m, self.j = mesh.shape[self.tp], mesh.coords[self.tp]
        cfg = model_cfg
        self.stacked = cfg.n_groups() > 1
        bad = [k for k in cfg.pattern_layers() if k not in TP_KINDS]
        if cfg.moe is not None or cfg.encoder is not None or cfg.n_image_tokens or bad:
            what = "a mixture of experts" if cfg.moe is not None else \
                "an encoder" if cfg.encoder is not None else \
                "an image projection" if cfg.n_image_tokens else f"{sorted(set(bad))} blocks"
            raise NotImplementedError(
                f"{cfg.name}: {what} on a GridMesh is not ported yet ({ROADMAP_REST})")

        def last_is_tp(name):
            return all(spec[-1] == self.tp for p, spec in specs.items()
                       if p.split("/")[-1] == name and p.startswith("groups/"))

        m = self.m
        self.attn_tp = (m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
                        and all(last_is_tp(n) for n in ("wq", "wk", "wv")))
        self.mlp_tp = (m > 1 and cfg.d_ff % m == 0
                       and all(last_is_tp(n) for n in ("wi", "wg")))
        table = specs["embed/embed"]
        self.vocab_tp = m > 1 and table[0] == self.tp and (
            cfg.tie_embeddings or specs["head"][-1] == self.tp)

    # -- roles and gathers ---------------------------------------------------

    def role(self, path: str) -> str:
        name = path.split("/")[-1]
        if self.attn_tp and name in ("wq", "wk", "wv"):
            return "col"
        if self.mlp_tp and name in ("wi", "wg"):
            return "col"
        if (self.attn_tp and name == "wo") or (self.mlp_tp and name == "wd"):
            return "row"
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
        return gather(x, spec, self.mesh, axes, same)

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

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh, self.tp)

    def row_product(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``h @ w`` of the rank's input columns ``h`` (..., F/M) and the
        whole gathered ``w`` (F, d): the f32 partial product of the rank's
        rows of w (rounded to h's dtype as the single-device product rounds
        the weight), summed over the model axis in f32, cast once."""
        f = w.shape[0] // self.m
        rows = w.narrow(0, self.j * f, f).to(h.dtype)
        return self.reduce(_RowProduct.apply(h, rows)).to(h.dtype)

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
