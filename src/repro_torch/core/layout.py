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

``GridShard`` and ``GridParams`` are their counterparts under the weights'
FSDP+TP sharding on a (data, model) grid (sharding/placement.py): each
rank's spec blocks of the leaves packed into a flat buffer of their own,
whose per-leaf maps point at the whole leaves, so no buffer of the step
holds the whole model's layout on one rank.
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


def nest_paths(flat: Dict[str, Any]):
    """{"a/0/b": x, ...} -> {"a": [{"b": x}]}: ``tree_paths``' inverse on
    the paths themselves (a node whose keys are all digits becomes a list)."""
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node

    return lists(root)


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _unflatten(skel, leaves):
    return _build(skel, iter(leaves))


def _build(node, it):
    # a module function, not a recursive closure: a closure that calls itself
    # is a reference cycle holding ``it``, and through it every leaf (views
    # of a whole flat buffer) until the cyclic garbage collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)} if node else {}
    if isinstance(node, list):
        return [_build(v, it) for v in node]
    return next(it)


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
        ``block_leaf_ids`` (n_blocks,) int32, ``row_ids`` (rows,) int64 (the
        leaf of each row, 0 for a padding row) and the layout's
        ``inv_sizes``."""
        device = torch.device(device)
        meta = self._meta.get(device)
        if meta is None:
            lids = torch.as_tensor(self.block_leaf_ids(), device=device)
            meta = self._meta[device] = {
                "block_leaf_ids": lids,
                "row_ids": lids.long().repeat_interleave(self.layout.block_rows),
                "inv_sizes": self.layout.device_meta(device)["inv_sizes"],
            }
        return meta

    def live(self, device) -> torch.Tensor:
        """(rows, LANE) bool, made once per device: True where an element
        of the shard's rows belongs to a leaf (``pad_mask``'s rows)."""
        key = ("live", torch.device(device))
        if key not in self._meta:
            self._meta[key] = self.local(pad_mask(self.layout, device)).clone()
        return self._meta[key]

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


def shard_rows(x: FlatBuffer, shard: RowShard) -> FlatBuffer:
    """``x`` as ``shard``'s rows: ``x`` itself when it holds a shard's rows
    already, else its rows of the whole buffer (``RowShard.local``)."""
    if x.shard is not None:
        return x
    return FlatBuffer(shard.local(x.data), x.layout, shard)


def unpack_tree(tree):
    """``tree`` with every FlatBuffer replaced by its unpacked stacked tree
    (views); dicts, lists and tuples are rebuilt, other leaves kept."""
    if is_flat(tree):
        if tree.shard is not None:
            raise ValueError("unpack_tree: a row-sharded FlatBuffer holds only its rank's rows; "
                             "gather it first (RowShard.gather)")
        return tree.unpack()
    if isinstance(tree, dict):
        return {k: unpack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unpack_tree(v) for v in tree]
    return tree


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
        layout = ParamLayout.for_tree(stacked)
        with torch.no_grad():
            data = layout.pack(stacked, torch.float32, device=device)
        self._bind(data, layout, n_groups)

    @classmethod
    def from_flat(cls, data: torch.Tensor, layout: "ParamLayout", n_groups: int) -> "FlatParams":
        """FlatParams over ``data``, an (n_rows, LANE) f32 buffer in
        ``layout`` (kept, not copied)."""
        self = cls.__new__(cls)
        self._bind(data, layout, n_groups)
        return self

    def _bind(self, data: torch.Tensor, layout: "ParamLayout", n_groups: int) -> None:
        if data.dtype != torch.float32 or tuple(data.shape) != (layout.n_rows, LANE):
            raise ValueError(f"FlatParams: data {tuple(data.shape)} {data.dtype}, want "
                             f"({layout.n_rows}, {LANE}) float32")
        self.layout = layout
        self.n_groups = n_groups
        self.data = data
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
    """(n_leaves,) f32 per-leaf sums of a flat buffer ``x``: each row summed
    in f32, the rows added up by leaf id in f64, each leaf's sum rounded
    once.  (Added up in f32, every addition of a row sum rounds to the
    growing sum's ulp: over the 13.6 M rows of DLRM's (26, 2^19, 128) tables
    leaf that drifts by percents.)"""
    row_ids = layout.device_meta(x.device)["row_ids"]
    out = torch.zeros(layout.n_leaves, dtype=torch.float64, device=x.device)
    return out.index_add_(0, row_ids, x.float().sum(dim=1).double()).float()


def rows_of(layout: ParamLayout, per_leaf: torch.Tensor) -> torch.Tensor:
    """(n_leaves,) per-leaf values broadcast to (n_rows, 1)."""
    return per_leaf[layout.device_meta(per_leaf.device)["row_ids"]][:, None]


class GridShard:
    """One rank's part of a layout's flat buffers on a launch/mesh.py::
    GridMesh: the rank's spec block of every leaf (sharding/rules.py),
    packed in the reference's leaf order into a flat buffer of its own
    (``local_layout``: the layout over the block shapes, each leaf's rows
    still whole blocks of one leaf), the counterpart of RowShard for the
    weights' FSDP+TP sharding.

    ``device_meta`` maps the local blocks to the global leaf ids and keeps
    the layout's ``inv_sizes`` of the WHOLE leaves, so the per-leaf kernels
    (K13, K16) and sums run on the local buffer as they are.  A leaf that
    is replicated over an axis is held whole along it by every rank there;
    its ``owner`` (the rank at coordinate 0 on each such axis) alone adds
    it to a sum over the grid (``owner_weights``, ``live``)."""

    def __init__(self, layout: ParamLayout, specs, mesh):
        from repro_torch.sharding.placement import shard_shape

        self.layout, self.specs, self.mesh = layout, tuple(specs), mesh
        sizes = dict(mesh.shape)
        shapes = tuple(shard_shape(s, sp, sizes) for s, sp in zip(layout.shapes, self.specs))
        self.local_layout = ParamLayout(layout.paths, shapes, layout.block_rows,
                                        skeleton=layout.skeleton)
        self.owner = np.array([all(mesh.coords[a] == 0 for a in mesh.axis_names
                                   if a not in sp.axes()) for sp in self.specs], bool)
        self.n_shards, self.index = mesh.size, mesh.rank
        self._meta: Dict = {}

    @property
    def rows(self) -> int:
        return self.local_layout.n_rows

    @property
    def held(self) -> int:
        """Elements of the rank's blocks (padding left out)."""
        return int(sum(self.local_layout.sizes))

    def device_meta(self, device) -> Dict[str, torch.Tensor]:
        """The local layout's ``block_leaf_ids`` and ``row_ids``, the whole
        layout's ``inv_sizes`` and ``owner`` (leaf_slots,) f32 1/0."""
        device = torch.device(device)
        meta = self._meta.get(device)
        if meta is None:
            own = np.zeros(self.layout.leaf_slots, np.float32)
            own[: self.layout.n_leaves] = self.owner
            local = self.local_layout.device_meta(device)
            meta = self._meta[device] = {
                "block_leaf_ids": local["block_leaf_ids"], "row_ids": local["row_ids"],
                "inv_sizes": self.layout.device_meta(device)["inv_sizes"],
                "owner": torch.as_tensor(own, device=device)}
        return meta

    def owner_weights(self, device) -> torch.Tensor:
        return self.device_meta(device)["owner"]

    def live(self, device) -> torch.Tensor:
        """(rows, LANE) bool: True where an element belongs to a leaf whose
        owner this rank is."""
        key = ("live", torch.device(device))
        if key not in self._meta:
            rid = self.device_meta(device)["row_ids"]
            own = torch.as_tensor(self.owner, device=device)[rid][:, None]
            self._meta[key] = pad_mask(self.local_layout, device) & own
        return self._meta[key]

    def local(self, buf: torch.Tensor) -> torch.Tensor:
        """The rank's local buffer: ``buf`` itself when it holds the local
        rows, else the rank's blocks of a whole (n_rows, LANE) buffer of the
        layout, packed (a new tensor)."""
        if buf.shape[0] == self.rows:
            return buf
        from repro_torch.sharding.placement import block_slices

        out = self.local_layout.zeros(buf.dtype, buf.device)
        sizes, coords = dict(self.mesh.shape), dict(self.mesh.coords)
        for dst, src, spec in zip(self.local_layout.leaf_views(out),
                                  self.layout.leaf_views(buf), self.specs):
            dst.copy_(src[block_slices(dst.shape, spec, coords, sizes)])
        return out

    def zeros(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return self.local_layout.zeros(dtype, device)

    def gather(self, local: torch.Tensor, mesh=None) -> torch.Tensor:
        """The whole (n_rows, LANE) buffer on every rank (a collective per
        leaf over the grid)."""
        from repro_torch.sharding.placement import gather_params

        mesh = self.mesh if mesh is None else mesh
        out = self.layout.zeros(local.dtype, local.device)
        leaves = gather_params(self.local_layout.leaf_views(local), list(self.specs), mesh)
        for dst, src in zip(self.layout.leaf_views(out), leaves):
            dst.copy_(src)
        return out


class GridParams:
    """The trainable parameters of one rank of a GridMesh: its blocks of
    every leaf in one local flat f32 buffer (``data``, GridShard's local
    layout) with its flat gradient ``grad``, as FlatParams holds the whole.

    ``tree`` is what the grid's forward reads (models/transformer.py::
    forward_grid): {"groups": [per group {path in the group: the group's
    slice of the rank's block}], "whole": {reference path: the rank's
    block}}, where the per-group leaves are the stacked leaves whose layer
    dim is not split (gathered one group at a time, on use) and "whole"
    holds every other leaf (gathered whole once per forward).  Each leaf
    shares ``data``'s storage and its ``.grad`` is the same slice of
    ``grad``, so autograd accumulates the gradients of the rank's blocks in
    place, and an in-place update of ``data`` is seen by every leaf."""

    def __init__(self, data: torch.Tensor, shard: GridShard, placement):
        if data.dtype != torch.float32 or tuple(data.shape) != (shard.rows, LANE):
            raise ValueError(f"GridParams: data {tuple(data.shape)} {data.dtype}, want "
                             f"({shard.rows}, {LANE}) float32")
        self.shard, self.placement = shard, placement
        self.layout, self.local_layout = shard.layout, shard.local_layout
        self.data = data
        self.grad = torch.zeros_like(data)
        n_groups = placement.cfg.n_groups()
        groups: List[Dict] = [{} for _ in range(n_groups)]
        whole: Dict[str, torch.Tensor] = {}
        from repro_torch.sharding.placement import group_path

        for path, view, gview in zip(self.layout.paths, self.local_layout.leaf_views(data),
                                     self.local_layout.leaf_views(self.grad)):
            if placement.group_dims(path):
                rest = group_path(path, True)
                for g in range(n_groups):
                    leaf = view[g].detach().requires_grad_(True)
                    leaf.grad = gview[g]
                    groups[g][rest] = leaf
            else:
                leaf = view.detach().requires_grad_(True)
                leaf.grad = gview
                whole[path] = leaf
        self.tree = {"groups": groups, "whole": whole}

    @classmethod
    def from_whole(cls, whole: torch.Tensor, shard: GridShard, placement,
                   device=None) -> "GridParams":
        """From a whole (n_rows, LANE) buffer of the layout (any device):
        the rank's blocks, on ``device``."""
        local = shard.local(whole)
        if local is whole:
            local = whole.clone()
        return cls(local.to(device or whole.device, torch.float32).contiguous(), shard,
                   placement)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def stacked(self, which: str = "data") -> Dict:
        """The rank's blocks of ``data`` or ``grad`` as the reference-shaped
        tree of local leaves (views)."""
        return self.local_layout.unpack(getattr(self, which))

    def zero_grad(self) -> None:
        self.grad.zero_()

    def gather(self) -> torch.Tensor:
        """The whole (n_rows, LANE) params buffer on every rank (a
        collective)."""
        return self.shard.gather(self.data)
