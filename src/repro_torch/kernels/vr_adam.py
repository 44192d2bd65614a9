"""Per-leaf VR-Adam inner step (K19): the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro/kernels/vr_adam.py::vr_adam_inner`` (TPU kernel
``_kernel``): GSNR -> p momentum -> bias-corrected ghat -> m/v moments ->
bias-corrected Adam direction, on ONE parameter leaf, returning new f32
(dir, m', v', p').  The flat single-launch form is
``flat_update.py::flat_vr_adam``.  The kernel is ``csrc/vr_leaf.cu``;
inv_mean comes from the plain prepass and the operands are padded as in
``vr_update.py``.  On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it computes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vr_update import (SIGNATURES, check_leaf, clip_r, inv_mean_r, pad2d,
                                           stream_args, unpad)


def adam_math_ref(g, ga, g2, m, v, p, inv, *, b1, b2, b3, eps, gamma, gsnr_eps, bc1, bc2, bc3):
    """Plain per-element VR-Adam chain in f32 -> (dir, m', v', p')."""
    r = clip_r(g.float(), g2.float(), inv, gamma, gsnr_eps)
    p_new = b3 * p.float() + (1.0 - b3) * r
    ghat = (p_new / bc3) * ga.float()
    m_new = b1 * m.float() + (1.0 - b1) * ghat
    v_new = b2 * v.float() + (1.0 - b2) * ghat * ghat
    return (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new, p_new


def vr_adam_inner_ref(g, g2, m, v, p, bc1, bc2, bc3, *, b1, b2, b3, eps, gamma, gsnr_eps,
                      g_apply=None):
    """Plain version of ``vr_adam_inner``."""
    ga = g if g_apply is None else g_apply
    return adam_math_ref(g, ga, g2, m, v, p, inv_mean_r(g, g2, gsnr_eps), b1=b1, b2=b2, b3=b3,
                         eps=eps, gamma=gamma, gsnr_eps=gsnr_eps, bc1=float(bc1),
                         bc2=float(bc2), bc3=float(bc3))


def vr_adam_inner(g, g2, m, v, p, bc1, bc2, bc3, *, b1, b2, b3, eps, gamma, gsnr_eps,
                  g_apply=None):
    """Fused inner step on one tensor: returns (dir, m', v', p') f32 in
    ``g``'s shape.  bcN = 1 - betaN**t; ``g_apply`` is the gradient entering
    the moments (None means g); the GSNR ratio derives from (g, g2)."""
    ga = g if g_apply is None else g_apply
    if g.device.type == "cpu":
        return vr_adam_inner_ref(g, g2, m, v, p, bc1, bc2, bc3, b1=b1, b2=b2, b3=b3, eps=eps,
                                 gamma=gamma, gsnr_eps=gsnr_eps, g_apply=g_apply)
    if g.device.type != "cuda":
        raise ValueError(f"vr_adam_inner: no implementation for device {g.device}")
    ops = [pad2d(t) for t in (g, ga, g2, m, v, p)]
    check_leaf("vr_adam_inner", ops)
    inv = inv_mean_r(g, g2, gsnr_eps)
    outs = [torch.empty_like(ops[0]) for _ in range(4)]
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_vr_adam(*(t.data_ptr() for t in ops), None, inv.data_ptr(),
                           *(t.data_ptr() for t in outs), None, outs[0].numel(),
                           b1, b2, b3, eps, 0.0, gamma, gsnr_eps, float(bc1), float(bc2),
                           float(bc3), 0, *stream_args(outs[0]))
    _build.check(err, "leaf_vr_adam")
    vr_adam_inner.launches += 1
    return tuple(unpad(t, g.shape) for t in outs)


vr_adam_inner.launches = 0
