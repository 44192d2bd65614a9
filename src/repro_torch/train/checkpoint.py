"""Checkpoints in the reference's format: whole train states, and weights.

The reference (``repro/train/checkpoint.py``) saves any pytree to .npz with
each leaf keyed by its '/'-joined tree path, in ``jax.tree_util`` order:
dict keys sorted, NamedTuple fields by name, list and tuple entries by
index; a None field (``TrainState.k`` on a fixed-k run) gives no leaf.  bf16
is stored as f32 (lossless) and cast back to the template leaf's dtype at
restore.  ``save`` and ``restore`` here write and read that format for the
port's trees of TrainStates, dicts, lists, NamedTuples, tensors, numpy
values and Python numbers, so a checkpoint of either package restores into
the other:

  * the params (a FlatParams) and every FlatBuffer of optimizer state are
    saved as the reference's stacked tree (``FlatBuffer.unpack``) and packed
    again at restore into the template's layout, dtype and device, so flat-
    and tree-state checkpoints interchange.  A buffer's padding (the tail
    rows of each leaf, which hold no parameter) is not stored and restores
    as zero: only VR-Adam/LAMB's p is nonzero there after a step (the GSNR
    ratio clipped to gamma), and it only ever multiplies a zero gradient;
  * the port's Python-int counters (the step, the optimizer's step and pt,
    k) are stored as int32 scalars, as the reference's jitted step leaves
    them, and restore as Python ints;
  * a host leaf (numpy, e.g. data/memmap.py::DataState's int64 cursor)
    keeps the template's numpy dtype; a tensor is restored onto the
    template's device and dtype;
  * under a data mesh, a row-sharded FlatBuffer (core/layout.py::RowShard)
    is gathered before the save (every rank calls ``save``; rank 0 writes)
    and each rank restores its own rows;
  * on a GridMesh (the weights' FSDP+TP sharding) the params (a
    core/layout.py::GridParams) and the flat state (FlatBuffers of a
    GridShard) are gathered whole to every rank the same way, rank 0 writes
    the reference's file, and at restore each rank reads the whole leaves
    and keeps its own blocks.  Tree state of a rank's blocks (the
    baselines', and the reference plan's VR state) goes through the same
    flat form: packed into the rank's local layout, gathered whole, and at
    restore unpacked from the rank's blocks in the template's dtype.

Files are written to ``path + ".tmp"`` and moved into place with
``os.replace``.

Weights alone: the reference's transformer stacks the layer groups along a
leading ``n_groups`` axis (``groups/pos0/attn/wq`` has shape (n_groups, d,
H*hd)) when it scans them, or keeps a list (``groups/0/pos0/...``)
otherwise.  The port's tree holds one entry per group
(models/transformer.py), so ``params_from_numpy``/``load_npz`` split stacked
leaves and ``save_npz`` stacks them.  Weights keep the reference's (in, out)
layout: nothing is transposed.  ``flat_from_numpy`` packs a reference tree
(its params or an unpacked m/v/p state) row for row as the reference's
ParamLayout does, and ``flat_to_numpy`` is the inverse.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import (FlatBuffer, FlatParams, GridParams, ParamLayout, is_flat,
                                     nest_paths, stack_groups, tree_leaves)


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no native bf16: go through f32 (lossless)
        t = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cpu", dtype=None) -> Dict:
    """The reference's param tree (numpy leaves, e.g. ``jax.device_get`` of
    ``repro.models.init_params``) as the port's tree of tensors on
    ``device``; ``dtype`` None keeps each leaf's dtype."""
    out = {}
    for key, val in tree.items():
        if key == "groups" and isinstance(val, dict):  # stacked: split the group axis
            n = cfg.n_groups()
            val = [_unstack(val, i) for i in range(n)]
        out[key] = _convert(val, device, dtype)
    out.setdefault("tail", [])
    return out


def load_npz(path: str, cfg: ModelConfig, device="cpu", dtype=None) -> Dict:
    """Read a reference-format .npz params checkpoint into the port's tree."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(nest_paths(flat), cfg, device=device, dtype=dtype)


def save_npz(path: str, params: Dict, cfg: ModelConfig) -> None:
    """Write the port's params in the reference format: group leaves stacked
    along a leading n_groups axis (the reference's scanned layout) when
    there is more than one group, bf16 stored as f32."""
    save(path, stack_groups(params))


def flat_from_numpy(tree: Dict[str, Any], layout: ParamLayout = None, device="cpu",
                    dtype=torch.float32) -> torch.Tensor:
    """The reference's stacked tree (numpy leaves) packed into the port's
    ``(n_rows, 128)`` layout (``layout`` defaults to the tree's own)."""
    layout = layout or ParamLayout.for_tree(tree)
    return layout.pack(_convert(tree, device, torch.float32), dtype, device=device)


def flat_to_numpy(buf: torch.Tensor, layout: ParamLayout) -> Dict[str, Any]:
    """Inverse of ``flat_from_numpy``: the stacked tree of f32 numpy arrays."""
    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_np(v) for v in tree]
        return tree.detach().float().cpu().numpy()

    return to_np(layout.unpack(buf))


# -- whole trees: save / restore -------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _host_array(leaf) -> np.ndarray:
    """A leaf as the array the reference stores for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _items(tree, prefix: str, mesh, out: List[Tuple[str, Any]]) -> None:
    """(path, leaf) pairs of ``tree`` in the reference's tree-path form."""
    if tree is None:
        return
    if isinstance(tree, FlatParams):
        _items(tree.stacked(), prefix, mesh, out)
    elif isinstance(tree, GridParams):
        _items(tree.layout.unpack(tree.gather()), prefix, mesh, out)
    elif is_flat(tree):
        data = tree.data
        if tree.shard is not None:
            if mesh is None:
                raise ValueError("save: a row-sharded FlatBuffer needs the mesh to gather it "
                                 "(save(path, tree, mesh=...), called on every rank)")
            data = tree.shard.gather(data, mesh)
        _items(tree.layout.unpack(data), prefix, mesh, out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _items(getattr(tree, name), f"{prefix}{name}/", mesh, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _items(tree[k], f"{prefix}{k}/", mesh, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _items(v, f"{prefix}{i}/", mesh, out)
    else:
        out.append((prefix[:-1], tree))


_STATE_BUFFERS = ("m", "v", "p")


def _grid_flat_state(tree: Any) -> Any:
    """A TrainState on a GridMesh with its tree state of the rank's blocks
    as FlatBuffers of its GridShard (in the trees' dtype); any other tree
    as it is."""
    params = getattr(tree, "params", None)
    if not isinstance(params, GridParams):
        return tree
    sh = params.shard
    opt = {}
    for k, v in tree.opt_state.items():
        if k in _STATE_BUFFERS and not is_flat(v):
            dtype = tree_leaves(v)[0].dtype
            v = FlatBuffer(sh.local_layout.pack(v, dtype, params.device), sh.layout, sh)
        opt[k] = v
    return tree._replace(opt_state=opt)


def _grid_trees(back: Any, like: Any) -> Any:
    """``back`` (restored through ``_grid_flat_state(like)``) with each
    state buffer that is a tree in ``like`` unpacked from the rank's blocks
    (views of the restored local buffer)."""
    if not isinstance(getattr(like, "params", None), GridParams):
        return back
    opt = dict(back.opt_state)
    for k, v in like.opt_state.items():
        if k in _STATE_BUFFERS and not is_flat(v):
            opt[k] = like.params.local_layout.unpack(opt[k].data)
    return back._replace(opt_state=opt)


def save(path: str, tree: Any, mesh=None) -> None:
    """Write ``tree`` to ``path`` in the reference's .npz format.  Under a
    data mesh every rank calls it (the sharded state is gathered, a
    collective), rank 0 writes, and every rank returns once the file is in
    place."""
    tree = _grid_flat_state(tree)
    items: List[Tuple[str, Any]] = []
    _items(tree, "", mesh, items)
    if mesh is None or mesh.rank == 0:
        arrays = {key: _host_array(leaf) for key, leaf in items}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()


def _read(data, key: str, shape) -> np.ndarray:
    if key not in data:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = data[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(shape)}")
    return arr


def _flat_from(data, prefix: str, layout: ParamLayout, dtype, device) -> torch.Tensor:
    """A new (n_rows, LANE) buffer of ``layout`` filled leaf by leaf from the
    checkpoint's stacked leaves under ``prefix``."""
    buf = layout.zeros(dtype, device)
    for view, p, shape in zip(layout.leaf_views(buf), layout.paths, layout.shapes):
        view.copy_(torch.from_numpy(_read(data, prefix + p, shape)))
    return buf


def _restore(data, like, prefix: str):
    if like is None:
        return None
    if isinstance(like, FlatParams):
        buf = _flat_from(data, prefix, like.layout, torch.float32, like.device)
        return FlatParams.from_flat(buf, like.layout, like.n_groups)
    if isinstance(like, GridParams):  # the whole leaves read, the rank's blocks kept
        buf = _flat_from(data, prefix, like.layout, torch.float32, like.device)
        return GridParams.from_whole(buf, like.shard, like.placement)
    if is_flat(like):
        buf = _flat_from(data, prefix, like.layout, like.dtype, like.data.device)
        if like.shard is not None:  # the rank's rows, in storage of their own
            buf = like.shard.local(buf).clone()
        return FlatBuffer(buf, like.layout, like.shard)
    if _is_namedtuple(like):
        return type(like)(*[_restore(data, getattr(like, n), f"{prefix}{n}/")
                            for n in like._fields])
    if isinstance(like, dict):
        return {k: _restore(data, v, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(data, v, f"{prefix}{i}/") for i, v in enumerate(like))
    key = prefix[:-1]
    if isinstance(like, torch.Tensor):
        arr = _read(data, key, like.shape)
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(_read(data, key, ()))
    tmpl = np.asarray(like)
    return np.asarray(_read(data, key, tmpl.shape), dtype=tmpl.dtype)


def restore(path: str, like: Any) -> Any:
    """A new tree shaped like the template ``like``, its leaves read from
    ``path`` (see the module note); raises KeyError on a missing leaf and
    ValueError on a shape mismatch."""
    with np.load(path) as data:
        return _grid_trees(_restore(data, _grid_flat_state(like), ""), like)
