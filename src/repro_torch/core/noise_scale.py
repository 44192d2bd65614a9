"""Online gradient noise scale (critical batch size) from the GradStats carry.

Port of ``repro/core/noise_scale.py``.  McCandlish et al.'s "simple noise
scale" B_simple ~ tr(Sigma)/|G|^2, read off the moments the train step has
already built: the flat carry (K3, then K4) holds mean = E_d[g_d] and
sq_mean = E_d[g_d^2] of the k groups, so both squared gradient norms the
estimator needs are plain reductions over buffers that are already there:

    |G_small|^2  =  sum_elem E_d[g_d^2]     =  sum(sq_mean buffer)
    |G_big|^2    =  sum_elem (E_d[g_d])^2   =  sum(mean buffer ** 2)

The flat buffers' tail padding is zero (core/layout.py), so sums over the
packed buffer are exact: |G_big|^2 is one dot product of the mean buffer
with itself and |G_small|^2 one sum, each a single read of its buffer; the
per-leaf decomposition is ONE segment-sum of the row sums over
``layout.row_leaf_ids()`` (``index_add_``).  With
B_small = batch/k and B_big = batch, the unbiased estimators are

    tr(Sigma) ~ (|G_small|^2 - |G_big|^2) / (1/B_small - 1/B_big)
    |G|^2     ~ (B_big |G_big|^2 - B_small |G_small|^2) / (B_big - B_small)
    B_simple  = tr(Sigma) / |G|^2

tr(Sigma) is the difference of two f32 sums that are close to each other,
so summation order alone moves it; the sums themselves are what to hold to
a relative bound.  Per-step estimates are noisy: callers smooth tr(Sigma)
and |G|^2 with the bias-corrected EMA below and take the ratio of the
debiased averages, never an EMA of the ratio.

Everything here is plain PyTorch on tensors the step already holds, as it
is jnp in the reference: no kernel runs for it (train/trainer.py's
``noise_scale=True`` step launches exactly what the plain step does).
train/autoscale.py turns the smoothed estimate into accumulation-count
decisions.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import GridShard, is_flat, tree_leaves


def ema(avg, beta, yi, i):
    """Exponential moving average with bias correction.

    Returns (new_avg, debiased) where debiased = avg / (1 - beta**(i+1));
    ``i`` is the zero-based update index.  Works on floats and tensors."""
    if avg is None:
        avg = 0
    avg = beta * avg + (1 - beta) * yi
    return avg, avg / (1 - beta ** (i + 1))


class NoiseTerms(NamedTuple):
    """The two squared-norm readings the estimator consumes.

    g2_small: E_d |g_d|^2  — expected squared norm of a size-B/k group gradient
    g2_big:   |E_d g_d|^2  — squared norm of the accumulated full-batch gradient
    per_leaf: optional (n_leaves, 2) [g2_big, g2_small] decomposition
    """

    g2_small: torch.Tensor
    g2_big: torch.Tensor
    per_leaf: Optional[torch.Tensor] = None


def _grid_sums(per_leaf: torch.Tensor, grid) -> torch.Tensor:
    """(n, n_leaves) f64 per-leaf sums of a rank's blocks -> the sums over
    the grid, each leaf from its owners only (backend.GridSpmd)."""
    return grid.leaf_totals(per_leaf)


def _grid_terms(stats: GradStats, per_leaf: bool, grid) -> NoiseTerms:
    """``noise_terms`` of a carry of a rank's blocks on a GridMesh: per-leaf
    sums of the blocks, owner-weighted and all-reduced over the grid (a
    plain sum of every rank's blocks would count a leaf replicated over M
    model ranks M times)."""
    if is_flat(stats.mean):
        sums = [grid.flat_leaf_sums(stats.mean.data.square()),
                grid.flat_leaf_sums(stats.sq_mean.data)]
    else:
        sums = [torch.stack([x.double().square().sum() for x in tree_leaves(stats.mean)]),
                torch.stack([x.double().sum() for x in tree_leaves(stats.sq_mean)])]
    leaf = _grid_sums(torch.stack(sums), grid).T.float()
    return NoiseTerms(g2_small=torch.sum(leaf[:, 1]), g2_big=torch.sum(leaf[:, 0]),
                      per_leaf=leaf if per_leaf else None)


def noise_terms(stats: GradStats, *, per_leaf: bool = False, mesh=None, grid=None
                ) -> NoiseTerms:
    """Read |G_small|^2 and |G_big|^2 off a GradStats carry: flat carries in
    one pass over the packed buffers (one segment-sum when ``per_leaf``),
    tree carries leaf by leaf (the same values up to summation order).  A
    flat carry of a rank's rows (FlatBuffers with a ``shard``) sums its
    rows, then one all-reduce over ``mesh`` adds the ranks' sums (padding
    rows are zero).  A carry of a rank's blocks on a GridMesh (``grid``, its
    backend.GridSpmd; flat or trees) sums per leaf, each leaf from its
    owners only."""
    if stats.sq_mean is None:
        raise ValueError(
            "noise_terms needs second moments (GradStats.sq_mean is None — "
            "this is a squares=False stale-step carry; estimate on refresh "
            "steps only)"
        )
    if grid is not None:
        return _grid_terms(stats, per_leaf, grid)
    if is_flat(stats.mean):
        mean, sq = stats.mean, stats.sq_mean
        shard = mean.shard
        if isinstance(shard, GridShard):
            raise ValueError("noise_terms: the carry holds a rank's blocks; pass its grid plan")
        if shard is not None and mesh is None:
            raise ValueError("noise_terms: the carry holds a rank's rows; pass its mesh")
        if not per_leaf:  # one read of each buffer, no temporary
            m = mean.data.reshape(-1)
            terms = torch.stack([torch.sum(sq.data), torch.dot(m, m)])
            if shard is not None:
                mesh.all_reduce_(terms)
            return NoiseTerms(g2_small=terms[0], g2_big=terms[1])
        # (2, rows): lane-reduced [mean^2, sq_mean] rows, then one segment-sum
        rows = torch.stack([torch.sum(torch.square(mean.data), dim=-1),
                            torch.sum(sq.data, dim=-1)])
        meta = (mean.layout if shard is None else shard).device_meta(rows.device)
        leaf = torch.zeros((mean.layout.n_leaves, 2), dtype=rows.dtype, device=rows.device)
        leaf.index_add_(0, meta["row_ids"], rows.T)
        if shard is not None:
            mesh.all_reduce_(leaf)
        return NoiseTerms(g2_small=torch.sum(leaf[:, 1]), g2_big=torch.sum(leaf[:, 0]),
                          per_leaf=leaf)
    leaves_m = tree_leaves(stats.mean)
    leaves_s = tree_leaves(stats.sq_mean)
    leaf = torch.stack([torch.stack([torch.sum(torch.square(m)), torch.sum(s)])
                        for m, s in zip(leaves_m, leaves_s)])
    tot = torch.sum(leaf, dim=0)
    return NoiseTerms(g2_small=tot[1], g2_big=tot[0], per_leaf=leaf if per_leaf else None)


class NoiseScaleEstimate(NamedTuple):
    g2_small: torch.Tensor
    g2_big: torch.Tensor
    tr_sigma: torch.Tensor  # unbiased estimate of tr(Sigma), the gradient noise
    g2: torch.Tensor  # unbiased estimate of |G|^2, the gradient signal
    b_simple: torch.Tensor  # tr(Sigma)/|G|^2 — the raw (unsmoothed) noise scale


def estimate_from_terms(g2_small, g2_big, b_small: float, b_big: float) -> NoiseScaleEstimate:
    """Unbiased tr(Sigma), |G|^2, B_simple from the two norm readings."""
    if not b_big > b_small > 0:
        raise ValueError(
            f"noise-scale estimator needs b_big > b_small > 0, got "
            f"b_small={b_small}, b_big={b_big} (is k >= 2?)"
        )
    g2_small, g2_big = torch.as_tensor(g2_small), torch.as_tensor(g2_big)
    tr_sigma = (g2_small - g2_big) / (1.0 / b_small - 1.0 / b_big)
    g2 = (b_big * g2_big - b_small * g2_small) / (b_big - b_small)
    zero = g2 == 0
    b_simple = tr_sigma / torch.where(zero, torch.ones_like(g2), g2)
    b_simple = torch.where(zero, torch.full_like(b_simple, math.inf), b_simple)
    return NoiseScaleEstimate(g2_small=g2_small, g2_big=g2_big, tr_sigma=tr_sigma, g2=g2,
                              b_simple=b_simple)


def estimate(stats: GradStats, b_small: float, b_big: float, mesh=None,
             grid=None) -> NoiseScaleEstimate:
    """GradStats carry -> NoiseScaleEstimate (see the module note); ``mesh``
    for a carry of a rank's rows, ``grid`` for one of a rank's blocks."""
    terms = noise_terms(stats, mesh=mesh, grid=grid)
    return estimate_from_terms(terms.g2_small, terms.g2_big, b_small, b_big)


class NoiseScaleState(NamedTuple):
    """Host-side EMA state: smooth tr(Sigma) and |G|^2 separately, then take
    the ratio of the debiased averages — never an EMA of the per-step ratio."""

    count: int = 0
    noise_avg: float = 0.0  # biased EMA of tr(Sigma)
    signal_avg: float = 0.0  # biased EMA of |G|^2


class SmoothedNoiseScale(NamedTuple):
    noise: float  # debiased EMA of tr(Sigma)
    signal: float  # debiased EMA of |G|^2
    b_simple: float  # ratio of the two (nan until signal is usable)


def init_noise_state() -> NoiseScaleState:
    return NoiseScaleState()


def update_noise_state(
    state: NoiseScaleState, tr_sigma: float, g2: float, beta: float = 0.9
) -> Tuple[NoiseScaleState, SmoothedNoiseScale]:
    """One EMA step; returns (new_state, smoothed readings)."""
    noise_avg, noise_hat = ema(state.noise_avg, beta, float(tr_sigma), state.count)
    signal_avg, signal_hat = ema(state.signal_avg, beta, float(g2), state.count)
    new = NoiseScaleState(state.count + 1, noise_avg, signal_avg)
    if signal_hat > 0 and math.isfinite(signal_hat) and math.isfinite(noise_hat):
        b_simple = noise_hat / signal_hat
    else:
        b_simple = float("nan")
    return new, SmoothedNoiseScale(noise=noise_hat, signal=signal_hat, b_simple=b_simple)
