"""Per-leaf gradient-moment carry (K22, K23): the wrappers and their plain
versions.

Counterpart of ``repro/kernels/grad_stats.py`` (TPU kernels
``_accum_kernel`` behind ``moments_accum`` and ``_finalize_kernel`` behind
``moments_finalize``): the k-microbatch carry of ONE parameter leaf in the
reference's padded (rows, 128) f32 layout.

  moments_init(leaf)                        -> zero (rows, 128) f32 carry
  moments_accum(gs2d, g2s2d, g)             gs += g, g2s += g * g
  moments_finalize(gs2d, g2s2d, k, shape)   -> (mean, sq_mean) in ``shape``

The flat carry over the whole parameter set (``flat_stats.py``, K3/K4)
runs the same element-wise math, so on a CUDA tensor these launch K3's and
K4's kernels of ``csrc/flat_stats.cu`` on the one-leaf carry, counted here
as their own launches.  The raw gradient leaf is cast and zero-padded by a
plain op first (``vr_update.pad2d``, as the reference's ``_pad2d``).  The
carry is updated IN PLACE and returned (the reference returns new arrays
with the same values); the finalize's outputs are unpadded views of it.
On a CPU tensor each computes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels.vr_update import LANE, pad2d, padded_rows, unpad


def moments_init(leaf: torch.Tensor) -> torch.Tensor:
    """Zero carry in the padded layout for one parameter leaf."""
    return torch.zeros((padded_rows(leaf.numel()), LANE), dtype=torch.float32,
                       device=leaf.device)


def moments_accum_ref(gs2d, g2s2d, g):
    """Plain version of ``moments_accum``, in place."""
    return fs.moments_accum_ref(gs2d, g2s2d, pad2d(g))


def moments_finalize_ref(gs2d, g2s2d, k, shape):
    """Plain version of ``moments_finalize``, in place."""
    mean, sq = fs.moments_finalize_ref(gs2d, g2s2d, k)
    return unpad(mean, shape), unpad(sq, shape)


def moments_accum(gs2d: torch.Tensor, g2s2d: torch.Tensor, g: torch.Tensor):
    """One microbatch's gradient leaf ``g`` (any float dtype, the leaf's
    shape) into the padded carries, in place: returns (gs2d, g2s2d)."""
    if gs2d.device.type == "cpu":
        return moments_accum_ref(gs2d, g2s2d, g)
    if gs2d.device.type != "cuda":
        raise ValueError(f"moments_accum: no implementation for device {gs2d.device}")
    fs.launch_accum("moments_accum", gs2d, g2s2d, pad2d(g))
    moments_accum.launches += 1
    return gs2d, g2s2d


def moments_finalize(gs2d: torch.Tensor, g2s2d: torch.Tensor, k, shape):
    """The terminal /k of both carries, in place: (mean, sq_mean) f32 in
    ``shape`` (views of the carries)."""
    if gs2d.device.type == "cpu":
        return moments_finalize_ref(gs2d, g2s2d, k, shape)
    if gs2d.device.type != "cuda":
        raise ValueError(f"moments_finalize: no implementation for device {gs2d.device}")
    fs.launch_finalize("moments_finalize", gs2d, g2s2d, k)
    moments_finalize.launches += 1
    return unpad(gs2d, shape), unpad(g2s2d, shape)


moments_accum.launches = 0
moments_finalize.launches = 0
