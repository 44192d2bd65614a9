"""Per-leaf VR-LAMB and VR-LARS steps (K20, K21): the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``repro/kernels/vr_lamb.py::vr_lamb_inner`` (TPU kernel
``_lamb_kernel``) and ``::vr_lars_inner`` (``_lars_kernel``): the whole
element-wise chain of one parameter leaf plus the norm sums its trust ratio
needs.

  vr_lamb_inner -> (u, m', v', p', sum(u^2), sum(w^2)),  u = dir + wd w
  vr_lars_inner -> (u, sum(u^2), sum(w^2)),               u = r ga + wd w

The caller applies the trust ratio.  The reference returns each sum from
(1, 128) lane partials (a TPU layout); here each is a 0-dim f32 tensor,
summed in two levels in f64 (each block's slots, then the last block adds
them in block order).
The flat single-launch forms are ``flat_update.py::flat_vr_lamb`` and
``::flat_vr_lars``.  The kernels are ``csrc/vr_leaf.cu``; inv_mean comes
from the prepass kernel (``vr_update.py::leaf_inv_mean``) and the operands
are padded as in ``vr_update.py``.
On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vr_adam import adam_math_ref
from repro_torch.kernels.vr_update import (SIGNATURES, check_leaf, clip_r, inv_mean_r,
                                           leaf_inv_mean, norm_scratch, pad2d, stream_args,
                                           unpad)


def vr_lamb_inner_ref(g, ga, g2, m, v, p, w, bc1, bc2, bc3, *, b1, b2, b3, eps, wd, gamma,
                      gsnr_eps):
    """Plain version of ``vr_lamb_inner``."""
    d, m_new, v_new, p_new = adam_math_ref(
        g, ga, g2, m, v, p, inv_mean_r(g, g2, gsnr_eps), b1=b1, b2=b2, b3=b3, eps=eps,
        gamma=gamma, gsnr_eps=gsnr_eps, bc1=float(bc1), bc2=float(bc2), bc3=float(bc3))
    wf = w.float()
    u = d + wd * wf
    return u, m_new, v_new, p_new, torch.sum(u * u), torch.sum(wf * wf)


def vr_lamb_inner(g, ga, g2, m, v, p, w, bc1, bc2, bc3, *, b1, b2, b3, eps, wd, gamma,
                  gsnr_eps):
    """Fused VR-LAMB step on one tensor: g is the group-mean gradient (the
    GSNR source), ga the gradient entering the update.  Returns (u, m', v',
    p') f32 in ``g``'s shape and the 0-dim f32 sums of u^2 and w^2."""
    if g.device.type == "cpu":
        return vr_lamb_inner_ref(g, ga, g2, m, v, p, w, bc1, bc2, bc3, b1=b1, b2=b2, b3=b3,
                                 eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps)
    if g.device.type != "cuda":
        raise ValueError(f"vr_lamb_inner: no implementation for device {g.device}")
    ops = [pad2d(t) for t in (g, ga, g2, m, v, p, w)]
    check_leaf("vr_lamb_inner", ops)
    inv = leaf_inv_mean(g, g2, gsnr_eps)
    outs = [torch.empty_like(ops[0]) for _ in range(4)]
    partials, ticket, acc = norm_scratch(g)
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_vr_adam(*(t.data_ptr() for t in ops), inv.data_ptr(),
                           *(t.data_ptr() for t in outs), acc.data_ptr(), partials.data_ptr(),
                           ticket.data_ptr(), outs[0].numel(),
                           b1, b2, b3, eps, wd, gamma, gsnr_eps, float(bc1), float(bc2),
                           float(bc3), 1, *stream_args(outs[0]))
    _build.check(err, "leaf_vr_lamb")
    vr_lamb_inner.launches += 1
    return (*(unpad(t, g.shape) for t in outs), acc[0], acc[1])


def vr_lars_inner_ref(g, ga, g2, w, *, wd, gamma, eps):
    """Plain version of ``vr_lars_inner``."""
    r = clip_r(g.float(), g2.float(), inv_mean_r(g, g2, eps), gamma, eps)
    wf = w.float()
    u = r * ga.float() + wd * wf
    return u, torch.sum(u * u), torch.sum(wf * wf)


def vr_lars_inner(g, ga, g2, w, *, wd, gamma, eps):
    """Fused VR-LARS scale on one tensor: (u f32 in ``g``'s shape, 0-dim f32
    sums of u^2 and w^2), u = r ga + wd w."""
    if g.device.type == "cpu":
        return vr_lars_inner_ref(g, ga, g2, w, wd=wd, gamma=gamma, eps=eps)
    if g.device.type != "cuda":
        raise ValueError(f"vr_lars_inner: no implementation for device {g.device}")
    ops = [pad2d(t) for t in (g, ga, g2, w)]
    check_leaf("vr_lars_inner", ops)
    inv = leaf_inv_mean(g, g2, eps)
    u = torch.empty_like(ops[0])
    partials, ticket, acc = norm_scratch(g)
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_vr_lars(*(t.data_ptr() for t in ops), inv.data_ptr(), u.data_ptr(),
                           acc.data_ptr(), partials.data_ptr(), ticket.data_ptr(), u.numel(),
                           gamma, wd, eps, *stream_args(u))
    _build.check(err, "leaf_vr_lars")
    vr_lars_inner.launches += 1
    return unpad(u, g.shape), acc[0], acc[1]


vr_lamb_inner.launches = 0
vr_lars_inner.launches = 0
