"""ParamLayout: one packed flat buffer for the whole parameter tree.

Port of ``repro/core/layout.py``.  A tree of tensors flattens into ONE
``(n_rows, LANE)`` buffer so the optimizer update and the gradient-moment
carry are single kernel passes over rows:

  * every leaf occupies a contiguous run of rows, zero-padded at its tail;
  * each leaf's row count is a multiple of ``block_rows`` (64), so every
    ``(block_rows, LANE)`` block belongs to exactly ONE leaf — a per-leaf
    ("layer") reduction accumulates by the block's leaf id;
  * the zero padding is kept by every element-wise pass (g = g2 = w = 0 in
    the tail), so per-leaf sums are exact without masking.

Leaf identity and order are the reference's: ``jax.tree_util.tree_flatten``
order (dict keys sorted, lists in index order) over the reference's
parameter tree with ``scan_layers=True``, where each parameter kind of the
layer groups is ONE stacked leaf (``groups/pos0/attn/wq`` of shape
``(n_groups, d, H*hd)``).  The per-leaf GSNR mean (paper eq. 8) and the LAMB
trust ratio therefore run over the stacked leaf.  The port's model keeps one
entry per group (``params["groups"][i]``); ``stack_groups`` /
``split_groups`` convert between the two forms.

``FlatParams`` keeps the trainable parameters themselves in one flat f32
buffer: each per-layer weight the model reads is a view of a contiguous
slice of its stacked leaf, and its ``.grad`` is a view of the same slice of
a flat gradient buffer, so autograd writes every microbatch's gradient
straight into the flat layout (no pack copy) and the update is applied to
the whole buffer at once.

``RowShard`` is one rank's contiguous row range of a flat buffer under data
parallelism (sharding/rules.py): the state of the per-shard optimizer
update lives in it, and ``gather`` puts the ranks' rows back together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

LANE = 128  # copy of repro/analysis/layout_contracts.py::LANE
SUBLANE = 8  # f32 sublane of the reference's tiling (block_rows must be a multiple)
FLAT_BLOCK_ROWS = 64  # rows per block: (64, 128) f32 = 32 KiB


def _leaf_rows(size: int, block_rows: int) -> int:
    """Rows a ``size``-element leaf occupies: ceil(size/LANE) rounded up to a
    whole number of blocks (so no block straddles two leaves)."""
    rows = -(-max(size, 1) // LANE)
    return -(-rows // block_rows) * block_rows


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten`` order: dict keys
    sorted, lists and tuples in index order, paths joined with '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_paths(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _unflatten(skel, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)} if node else {}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(skel)


def stack_groups(params: Dict) -> Dict:
    """The port's tree (``groups`` a list, one entry per group) in the
    reference's scanned form: with more than one group, each group leaf is
    stacked along a new leading axis (a copy).  One group stays a list, as
    in the reference."""
    out = dict(params)
    groups = params.get("groups", [])
    if isinstance(groups, list) and len(groups) > 1:
        out["groups"] = _stack(groups)
    return out


def _stack(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return torch.stack(list(items))


def split_groups(tree: Dict, n_groups: int) -> Dict:
    """Inverse of ``stack_groups``: a stacked ``groups`` dict becomes a list
    of ``n_groups`` per-group trees whose leaves are views (``leaf[i]``)."""
    out = dict(tree)
    groups = tree.get("groups")
    if isinstance(groups, dict):
        out["groups"] = [_index(groups, i) for i in range(n_groups)]
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Static flat-buffer layout for one tree structure.  Equality is
    geometry only (paths, shapes, block_rows)."""

    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    block_rows: int = FLAT_BLOCK_ROWS
    skeleton: Any = dataclasses.field(default=None, compare=False, repr=False)
    sizes: Tuple[int, ...] = dataclasses.field(init=False, compare=False, repr=False, default=())
    leaf_rows: Tuple[int, ...] = dataclasses.field(init=False, compare=False, repr=False, default=())
    row_offsets: Tuple[int, ...] = dataclasses.field(init=False, compare=False, repr=False, default=())
    _meta: Dict = dataclasses.field(init=False, compare=False, repr=False, default_factory=dict)

    def __post_init__(self):
        if self.block_rows % SUBLANE:
            raise ValueError(f"block_rows={self.block_rows} must be a multiple of {SUBLANE}")
        sizes = tuple(int(np.prod(s, dtype=np.int64)) if len(s) else 1 for s in self.shapes)
        rows = tuple(_leaf_rows(n, self.block_rows) for n in sizes)
        offs = tuple(int(x) for x in np.cumsum((0,) + rows)[:-1])
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "leaf_rows", rows)
        object.__setattr__(self, "row_offsets", offs)

    @classmethod
    def for_tree(cls, tree, block_rows: int = FLAT_BLOCK_ROWS) -> "ParamLayout":
        leaves = tree_paths(tree)
        return cls(tuple(p for p, _ in leaves), tuple(tuple(x.shape) for _, x in leaves),
                   block_rows, skeleton=_skeleton(tree))

    # -- geometry -----------------------------------------------------------

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def n_rows(self) -> int:
        return sum(self.leaf_rows)

    @property
    def n_blocks(self) -> int:
        return self.n_rows // self.block_rows

    @property
    def leaf_slots(self) -> int:
        """Leaf-id axis of the per-leaf accumulators, padded to 8."""
        return -(-self.n_leaves // SUBLANE) * SUBLANE

    def block_leaf_ids(self) -> np.ndarray:
        """(n_blocks, 1) int32: which leaf each block belongs to."""
        ids = np.repeat(np.arange(self.n_leaves, dtype=np.int32),
                        np.asarray(self.leaf_rows, np.int64) // self.block_rows)
        return ids.reshape(-1, 1)

    def row_leaf_ids(self) -> np.ndarray:
        """(n_rows,) int32 leaf id per row."""
        return np.repeat(np.arange(self.n_leaves, dtype=np.int32),
                         np.asarray(self.leaf_rows, np.int64))

    def leaf_inv_sizes(self) -> np.ndarray:
        """(leaf_slots, 1) f32: 1/size per leaf over the TRUE sizes (pad
        slots hold 1.0)."""
        inv = np.ones((self.leaf_slots, 1), np.float32)
        inv[: self.n_leaves, 0] = 1.0 / np.maximum(np.asarray(self.sizes, np.float64), 1.0)
        return inv

    def device_meta(self, device) -> Dict[str, torch.Tensor]:
        """The leaf maps as tensors on ``device`` (made once per device):
        ``block_leaf_ids`` (n_blocks,) int32, ``inv_sizes`` (leaf_slots,)
        f32 and ``row_ids`` (n_rows,) int64."""
        device = torch.device(device)
        meta = self._meta.get(device)
        if meta is None:
            meta = self._meta[device] = {
                "block_leaf_ids": torch.as_tensor(
                    np.ascontiguousarray(self.block_leaf_ids()[:, 0]), device=device),
                "inv_sizes": torch.as_tensor(
                    np.ascontiguousarray(self.leaf_inv_sizes()[:, 0]), device=device),
                "row_ids": torch.as_tensor(self.row_leaf_ids(), device=device).long(),
            }
        return meta

    # -- pack / unpack ------------------------------------------------------

    def check_tree(self, tree, what: str = "tree") -> list:
        """The leaves of ``tree`` in layout order; raises on a structure or
        shape that differs from the layout's."""
        leaves = tree_paths(tree)
        paths = tuple(p for p, _ in leaves)
        if paths != self.paths:
            raise ValueError(f"{what} structure does not match this ParamLayout:\n"
                             f"  layout paths: {self.paths}\n  {what} paths:  {paths}")
        for (path, leaf), shape in zip(leaves, self.shapes):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"{what} leaf {path} has shape {tuple(leaf.shape)}, "
                                 f"layout expects {shape}")
        return [x for _, x in leaves]

    def pack(self, tree, dtype=torch.float32, device=None) -> torch.Tensor:
        """Tree -> (n_rows, LANE) buffer in ``dtype``, zero tail padding."""
        leaves = [torch.as_tensor(x) for x in self.check_tree(tree, "pack input")]
        device = device if device is not None else (leaves[0].device if leaves else "cpu")
        buf = torch.zeros((self.n_rows, LANE), dtype=dtype, device=device)
        flat = buf.view(-1)
        for leaf, off, size in zip(leaves, self.row_offsets, self.sizes):
            flat[off * LANE: off * LANE + size].copy_(leaf.reshape(-1))
        return buf

    def leaf_views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf of ``buf`` as a view of its rows (no copy)."""
        if tuple(buf.shape) != (self.n_rows, LANE):
            raise ValueError(f"flat buffer {tuple(buf.shape)} != ({self.n_rows}, {LANE})")
        flat = buf.view(-1)
        return [flat[off * LANE: off * LANE + size].view(shape)
                for off, size, shape in zip(self.row_offsets, self.sizes, self.shapes)]

    def unpack(self, buf: torch.Tensor, dtype=None):
        """(n_rows, LANE) buffer -> tree of the layout's leaf shapes (views of
        ``buf`` unless ``dtype`` asks for a cast)."""
        leaves = self.leaf_views(buf)
        if dtype is not None:
            leaves = [x.to(dtype) for x in leaves]
        return _unflatten(self.skeleton, leaves)

    def zeros(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return torch.zeros((self.n_rows, LANE), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rank ``index`` of ``n_shards``'s contiguous rows of a layout's flat
    buffer.

    The layout's blocks split into ``n_shards`` equal contiguous ranges of
    ``n_blocks`` blocks; when they do not divide, zero blocks with leaf id 0
    pad the end (the reference's ``FlatSpmd._pad_rows`` / ``_meta``).  A
    padding row holds g = g2 = w = 0, so it adds exact zeros to every
    per-leaf sum, and it is dropped when the rows are gathered."""

    layout: ParamLayout
    n_shards: int
    index: int
    _meta: Dict = dataclasses.field(compare=False, repr=False, default_factory=dict)

    def __post_init__(self):
        if not 0 <= self.index < self.n_shards:
            raise ValueError(f"shard index {self.index} outside [0, {self.n_shards})")

    @property
    def n_blocks(self) -> int:
        """Blocks per shard, padding included."""
        return -(-self.layout.n_blocks // self.n_shards)

    @property
    def pad_blocks(self) -> int:
        """Zero blocks appended after the layout's last block."""
        return self.n_blocks * self.n_shards - self.layout.n_blocks

    @property
    def rows(self) -> int:
        return self.n_blocks * self.layout.block_rows

    @property
    def row_start(self) -> int:
        return self.index * self.rows

    @property
    def real_rows(self) -> int:
        """How many of the shard's rows lie in the layout (the rest pad)."""
        return max(0, min(self.rows, self.layout.n_rows - self.row_start))

    def block_leaf_ids(self) -> np.ndarray:
        """(n_blocks,) int32: the leaf of each of the shard's blocks, 0 for
        a padding block."""
        ids = np.zeros(self.n_blocks * self.n_shards, np.int32)
        ids[: self.layout.n_blocks] = self.layout.block_leaf_ids()[:, 0]
        return ids[self.index * self.n_blocks: (self.index + 1) * self.n_blocks].copy()

    def device_meta(self, device) -> Dict[str, torch.Tensor]:
        """The shard's maps on ``device`` (made once per device):
        ``block_leaf_ids`` (n_blocks,) int32 and the layout's
        ``inv_sizes``."""
        device = torch.device(device)
        meta = self._meta.get(device)
        if meta is None:
            meta = self._meta[device] = {
                "block_leaf_ids": torch.as_tensor(self.block_leaf_ids(), device=device),
                "inv_sizes": self.layout.device_meta(device)["inv_sizes"],
            }
        return meta

    def local(self, buf: torch.Tensor) -> torch.Tensor:
        """The shard's rows of a whole (n_rows, LANE) buffer: a view, or a
        copy with zero padding rows when the shard runs past the layout."""
        part = buf[self.row_start: self.row_start + self.real_rows]
        if self.real_rows == self.rows:
            return part
        out = torch.zeros((self.rows, LANE), dtype=buf.dtype, device=buf.device)
        out[: self.real_rows] = part
        return out

    def zeros(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return torch.zeros((self.rows, LANE), dtype=dtype, device=device)

    def gather(self, local: torch.Tensor, mesh) -> torch.Tensor:
        """Every rank's rows put together: the whole (n_rows, LANE) buffer,
        padding dropped (a collective: every rank of ``mesh`` calls it)."""
        out = torch.empty((self.n_shards * self.rows, LANE), dtype=local.dtype,
                          device=local.device)
        mesh.all_gather(out, local)
        return out[: self.layout.n_rows]


class FlatBuffer:
    """A flat buffer and its layout (the reference's pytree node).  With a
    ``shard``, ``data`` holds only that shard's rows."""

    __slots__ = ("data", "layout", "shard")

    def __init__(self, data: torch.Tensor, layout: ParamLayout,
                 shard: Optional[RowShard] = None):
        self.data = data
        self.layout = layout
        self.shard = shard

    def unpack(self, dtype=None):
        return self.layout.unpack(self.data, dtype)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self):
        where = "" if self.shard is None else f", shard={self.shard.index}/{self.shard.n_shards}"
        return f"FlatBuffer({self.shape}, {self.dtype}, leaves={self.layout.n_leaves}{where})"


def is_flat(x: Any) -> bool:
    return isinstance(x, FlatBuffer)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of dict/list trees of equal structure; a
    FlatBuffer is mapped through its data and keeps its layout (the
    reference's pytree node)."""
    if isinstance(tree, FlatBuffer):
        return FlatBuffer(fn(tree.data, *[r.data for r in rest]), tree.layout, tree.shard)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in layout order; a FlatBuffer is one leaf (its data)."""
    if isinstance(tree, FlatBuffer):
        return [tree.data]
    return [x for _, x in tree_paths(tree)]


class FlatParams:
    """Trainable parameters held in one flat f32 buffer.

    ``data`` and ``grad`` are ``(n_rows, LANE)`` f32 buffers in the layout of
    the reference's stacked tree.  ``tree`` is the port's per-group params
    tree; each leaf is a tensor that requires grad, shares ``data``'s
    storage (a contiguous slice of its stacked leaf) and whose ``.grad`` is
    the same slice of ``grad``.  Autograd therefore accumulates gradients
    in place into ``grad`` (``zero_grad`` before each backward), and an
    in-place update of ``data`` is seen by every leaf.
    """

    def __init__(self, params: Dict, n_groups: int, device=None):
        stacked = stack_groups(params)
        self.layout = ParamLayout.for_tree(stacked)
        self.n_groups = n_groups
        with torch.no_grad():
            self.data = self.layout.pack(stacked, torch.float32, device=device)
        self.grad = torch.zeros_like(self.data)
        data_tree = split_groups(self.layout.unpack(self.data), n_groups)
        grad_leaves = [g for _, g in tree_paths(split_groups(self.layout.unpack(self.grad),
                                                             n_groups))]
        paths = tree_paths(data_tree)
        leaves = []
        for (_, view), gview in zip(paths, grad_leaves):
            leaf = view.detach().requires_grad_(True)
            leaf.grad = gview
            leaves.append(leaf)
        self.tree = _unflatten(_skeleton(data_tree), leaves)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def stacked(self, which: str = "data") -> Dict:
        """The reference-shaped (stacked) tree of ``data`` or ``grad`` as
        views."""
        return self.layout.unpack(getattr(self, which))

    def zero_grad(self) -> None:
        self.grad.zero_()

    def detached_tree(self) -> Dict:
        """``tree`` with every leaf detached: the same storage, no autograd
        leaf and no ``.grad`` (what ``torch.func`` differentiates)."""
        return tree_map(lambda x: x.detach(), self.tree)

    def pack_stack(self, grads: Dict, k: int) -> torch.Tensor:
        """A gradient tree shaped like ``tree`` with a leading k axis ->
        one new (k, n_rows, LANE) f32 stack in this layout (the
        counterpart of the reference's ``jax.vmap(layout.pack)``).  Each
        leaf's (k, *leaf) gradient is written into the element range its
        parameter occupies in ``data``; the padded tail of every stacked
        leaf is zero."""
        layout = self.layout
        stack = torch.empty((k, layout.n_rows, LANE), dtype=torch.float32, device=self.device)
        flat = stack.view(k, -1)
        for off, size, rows in zip(layout.row_offsets, layout.sizes, layout.leaf_rows):
            flat[:, off * LANE + size: (off + rows) * LANE].zero_()
        base = self.data.storage_offset()
        for leaf, g in zip(tree_leaves(self.tree), tree_leaves(grads)):
            start = leaf.storage_offset() - base
            flat[:, start: start + leaf.numel()].copy_(g.reshape(k, -1))
        return stack


def pad_mask(layout: ParamLayout, device="cpu") -> torch.Tensor:
    """(n_rows, LANE) bool: True where an element belongs to a leaf."""
    mask = torch.zeros((layout.n_rows, LANE), dtype=torch.bool, device=device)
    for v in layout.leaf_views(mask):
        v.fill_(True)
    return mask


def leaf_sums(layout: ParamLayout, x: torch.Tensor) -> torch.Tensor:
    """(n_leaves,) f32 per-leaf sums of a flat buffer ``x`` (rows summed,
    then added up by leaf id)."""
    row_ids = layout.device_meta(x.device)["row_ids"]
    out = torch.zeros(layout.n_leaves, dtype=torch.float32, device=x.device)
    return out.index_add_(0, row_ids, x.float().sum(dim=1))


def rows_of(layout: ParamLayout, per_leaf: torch.Tensor) -> torch.Tensor:
    """(n_leaves,) per-leaf values broadcast to (n_rows, 1)."""
    return per_leaf[layout.device_meta(per_leaf.device)["row_ids"]][:, None]
