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


def normalize_per_layer(r: PyTree) -> PyTree:
    """r / mean(r) per parameter tensor ("layer", paper eq. 8)."""
    return tree_map(lambda x: x / torch.clamp(torch.mean(x), min=1e-30), r)


def clip_ratio(r: PyTree, gamma: float) -> PyTree:
    """clip to [gamma, 1] (paper eq. 9); gamma=1 reduces VRGD to the base opt."""
    return tree_map(lambda x: torch.clamp(x, gamma, 1.0), r)


def gsnr_scale(stats: GradStats, gamma: float = 0.1, eps: float = 1e-12) -> PyTree:
    """Full pipeline: the element-wise LR multiplier r(theta) in [gamma, 1]."""
    return clip_ratio(normalize_per_layer(raw_gsnr(stats, eps)), gamma)


def gsnr_summary(scale: PyTree, gamma: float = 0.1) -> dict:
    """Scalar diagnostics over every element: mean, min and the fraction
    clipped at the floor.  Reduced leaf by leaf (the reference concatenates
    the leaves first; the values are the same up to summation order)."""
    leaves = [x.reshape(-1) for x in tree_leaves(scale)]
    n = sum(x.numel() for x in leaves)
    total = torch.stack([x.double().sum() for x in leaves]).sum()
    floor = torch.stack([(x <= gamma * (1 + 1e-5)).sum() for x in leaves]).sum()
    return {
        "gsnr/mean": (total / n).float(),
        "gsnr/min": torch.stack([x.min() for x in leaves]).min(),
        "gsnr/frac_floor": (floor.double() / n).float(),
    }
