"""Weight carry-over between the reference checkpoint format and the port.

The reference (``repro/train/checkpoint.py``) saves a param pytree to .npz
with each leaf keyed by its '/'-joined tree path and bf16 stored as f32.
Its transformer stacks the layer groups along a leading ``n_groups`` axis
(``groups/pos0/attn/wq`` has shape (n_groups, d, H*hd)) when it scans them,
or keeps a list (``groups/0/pos0/...``) otherwise.  The port's tree holds
one entry per group (models/transformer.py), so stacked leaves are split
here.  Weights keep the reference's (in, out) layout: nothing is transposed.

Flat buffers (core/layout.py) carry across in the reference's stacked
layout: ``flat_from_numpy`` packs a reference tree (e.g. its params or an
unpacked m/v/p state) row for row as the reference's ParamLayout does, and
``flat_to_numpy`` is the inverse.  Saving and restoring a whole train state
is not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import ParamLayout


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


def _nest(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node

    return lists(root)


def load_npz(path: str, cfg: ModelConfig, device="cpu", dtype=None) -> Dict:
    """Read a reference-format .npz params checkpoint into the port's tree."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(_nest(flat), cfg, device=device, dtype=dtype)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:  # .npz has no bf16: store as f32 (lossless)
            t = t.float()
        out[prefix[:-1]] = t.numpy()


def save_npz(path: str, params: Dict, cfg: ModelConfig) -> None:
    """Write the port's params in the reference format: group leaves stacked
    along a leading n_groups axis (the reference's scanned layout) when
    there is more than one group, bf16 stored as f32."""
    tree = dict(params)
    groups = tree.pop("groups")
    flat: Dict[str, np.ndarray] = {}
    if cfg.n_groups() > 1:
        per_group = []
        for gp in groups:
            f: Dict[str, np.ndarray] = {}
            _flatten(gp, "", f)
            per_group.append(f)
        for key in per_group[0]:
            flat[f"groups/{key}"] = np.stack([f[key] for f in per_group])
    else:
        _flatten(groups, "groups/", flat)
    _flatten(tree, "", flat)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    os.replace(tmp, path)


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
