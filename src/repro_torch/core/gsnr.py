"""GSNR: gradient signal-to-noise ratio (paper sec. 3.1, 4.1).

Port of ``repro/core/gsnr.py``.  Pipeline (paper eq. 7 -> 2 -> 8 -> 9):

    variance   sigma^2 = E_d[g_d^2] - (E_d[g_d])^2          (k groups)
    gsnr       r       = g_mean^2 / sigma^2
    normalize  r      <- r / mean_layer(r)    (per parameter tensor)
    clip       r      <- clip(r, gamma, 1)

All element-wise except the per-layer mean.  A "layer" is a leaf of the
reference's stacked tree (core/layout.py): one parameter kind across all
layer groups.  ``GradStats`` carries the two raw moments.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.layout import is_flat, tree_leaves, tree_map

PyTree = Any


class GradStats(NamedTuple):
    """Per-parameter first/second moments of the k group gradient means.

    mean:    E_d[g_d]        — the usual (averaged) gradient
    sq_mean: E_d[g_d * g_d]  — mean of element-wise squared group gradients
    k:       number of groups (microbatches)

    On the fused-stats plan mean/sq_mean are FlatBuffers; ``as_tree()``
    unpacks them (views, no copy) for the per-layer pipeline below.
    """

    mean: PyTree
    sq_mean: PyTree
    k: int

    def as_tree(self) -> "GradStats":
        if not is_flat(self.mean):
            return self
        sq = self.sq_mean.unpack() if is_flat(self.sq_mean) else self.sq_mean
        return self._replace(mean=self.mean.unpack(), sq_mean=sq)


def variance(stats: GradStats) -> PyTree:
    """sigma^2 = E[g_d^2] - E[g_d]^2, clipped at 0 (paper eq. 7)."""
    stats = stats.as_tree()
    return tree_map(lambda s, m: torch.clamp(s - m * m, min=0.0), stats.sq_mean, stats.mean)


def raw_gsnr(stats: GradStats, eps: float = 1e-12) -> PyTree:
    """r = g^2 / sigma^2 (paper eq. 2 with the batch estimator of eq. 7)."""
    stats = stats.as_tree()
    return tree_map(lambda m, v: (m * m) / (v + eps), stats.mean, variance(stats))


def normalize_per_layer(r: PyTree, leaf_means=None) -> PyTree:
    """r / mean(r) per parameter tensor ("layer", paper eq. 8).  With
    ``leaf_means`` (tree -> each leaf's mean, in tree_leaves order) the
    means are its: a tree of a rank's blocks on a grid takes the whole
    leaves' means (backend.py::GridSpmd.tree_leaf_means)."""
    if leaf_means is None:
        return tree_map(lambda x: x / torch.clamp(torch.mean(x), min=1e-30), r)
    means = iter(leaf_means(r))
    return tree_map(lambda x: x / torch.clamp(next(means), min=1e-30), r)


def clip_ratio(r: PyTree, gamma: float) -> PyTree:
    """clip to [gamma, 1] (paper eq. 9); gamma=1 reduces VRGD to the base opt."""
    return tree_map(lambda x: torch.clamp(x, gamma, 1.0), r)


def gsnr_scale(stats: GradStats, gamma: float = 0.1, eps: float = 1e-12,
               leaf_means=None) -> PyTree:
    """Full pipeline: the element-wise LR multiplier r(theta) in [gamma, 1]
    (``leaf_means`` as for ``normalize_per_layer``)."""
    return clip_ratio(normalize_per_layer(raw_gsnr(stats, eps), leaf_means), gamma)


def _summary(total, floor, low, n: int) -> dict:
    return {
        "gsnr/mean": (total / n).float(),
        "gsnr/min": low,
        "gsnr/frac_floor": (floor.double() / n).float(),
    }


def _at_floor(x: torch.Tensor, gamma: float) -> torch.Tensor:
    return x <= gamma * (1 + 1e-5)


def gsnr_summary(scale: PyTree, gamma: float = 0.1) -> dict:
    """Scalar diagnostics over every element: mean, min and the fraction
    clipped at the floor.  Reduced leaf by leaf (the reference concatenates
    the leaves first; the values are the same up to summation order)."""
    leaves = [x.reshape(-1) for x in tree_leaves(scale)]
    return _summary(torch.stack([x.double().sum() for x in leaves]).sum(),
                    torch.stack([_at_floor(x, gamma).sum() for x in leaves]).sum(),
                    torch.stack([x.min() for x in leaves]).min(),
                    sum(x.numel() for x in leaves))


def gsnr_summary_rows(stats: GradStats, gamma: float, mesh, eps: float = 1e-12) -> dict:
    """``gsnr_summary(gsnr_scale(stats, gamma, eps), gamma)`` of a carry
    whose FlatBuffers hold this rank's rows of a layout (a RowShard) or its
    blocks of the leaves (a core/layout.py::GridShard, ``mesh`` the view of
    the whole grid): r of the rows (``raw_gsnr``), the per-leaf sums of r
    (f64) over the shard's live elements (the leaf elements it owns)
    all-reduced for the leaf means, ``clip_ratio``, then the summary's sum
    and floor count over the live elements all-reduced and the ranks'
    minima gathered; every rank returns the same values."""
    shard = stats.mean.shard
    layout = shard.layout
    r = raw_gsnr(GradStats(stats.mean.data, stats.sq_mean.data, stats.k), eps)
    rid = shard.device_meta(r.device)["row_ids"]
    live = shard.live(r.device)
    leaf = torch.zeros(layout.n_leaves, dtype=torch.float64, device=r.device)
    leaf = mesh.all_reduce_(
        leaf.index_add_(0, rid, torch.where(live, r, 0.0).double().sum(dim=1)))
    sizes = torch.tensor(layout.sizes, dtype=torch.float64, device=r.device)
    leaf_mean = torch.clamp((leaf / sizes).float(), min=1e-30)
    scale = clip_ratio(r / leaf_mean[rid][:, None], gamma)
    sums = mesh.all_reduce_(torch.stack([torch.where(live, scale, 0.0).double().sum(),
                                         (_at_floor(scale, gamma) & live).sum().double()]))
    low = torch.where(live, scale, torch.inf).min()[None]
    lows = mesh.all_gather(torch.empty(mesh.size, dtype=low.dtype, device=low.device), low)
    return _summary(sums[0], sums[1], lows.min(), sum(layout.sizes))
