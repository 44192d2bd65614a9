"""Flat VR-LAMB update: the CUDA kernels' wrapper and its plain version.

Counterpart of ``repro/kernels/flat_update.py::flat_vr_lamb`` (the TPU
kernel ``_vr_lamb_kernel``, bodies ``_raw_r``, ``_inv_mean_r``,
``_adam_math`` and ``_trust_ratio``).  The kernels are
``csrc/flat_update.cu`` (three launches: per-leaf sum of r, the element-wise
chain with the per-leaf norm sums, the trust-ratio apply); its source note
gives the design and bound.

``flat_vr_lamb`` returns ``(upd, m', v', p')``.  m', v', p' are written IN
PLACE into m, v, p (the reference returns new buffers with the same
values); upd is a new f32 buffer holding ``-lr * ratio * u``.  On a CUDA
tensor it launches the kernels or raises; on a CPU tensor it computes the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.backend import HOPPER, device_info
from repro_torch.core.baselines import _lamb_phi
from repro_torch.core.layout import LANE, ParamLayout, leaf_sums, rows_of
from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flat_vr_lamb": [_P] * 11 + [_I, _I, _I] + [_F] * 11 + [_P]}
STATE_DTYPES = (torch.float32, torch.bfloat16)


def raw_r(g, g2, gsnr_eps: float) -> torch.Tensor:
    """r = g^2 / (max(g2 - g^2, 0) + eps), in f32."""
    g, g2 = g.float(), g2.float()
    gg = g * g
    return gg / (torch.clamp(g2 - gg, min=0.0) + gsnr_eps)


def flat_vr_lamb_ref(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                     b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """Plain version of ``flat_vr_lamb`` (the same three phases in torch
    over the flat buffers); m, v, p are updated in place."""
    lr, bc1, bc2, bc3 = (float(x) for x in scal[:4])
    r_raw = raw_r(g, g2, gsnr_eps)
    inv = layout.device_meta(g.device)["inv_sizes"][: layout.n_leaves]
    inv_mean = 1.0 / torch.clamp(leaf_sums(layout, r_raw) * inv, min=1e-30)
    r = torch.clamp(r_raw * rows_of(layout, inv_mean), gamma, 1.0)
    del r_raw
    p_new = b3 * p.float() + (1.0 - b3) * r
    del r
    ghat = (p_new / bc3) * ga.float()
    m_new = b1 * m.float() + (1.0 - b1) * ghat
    v_new = b2 * v.float() + (1.0 - b2) * ghat * ghat
    del ghat
    wf = w.float()
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * wf
    un = torch.sqrt(leaf_sums(layout, u * u))
    pn = torch.sqrt(leaf_sums(layout, wf * wf))
    ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12), torch.ones_like(pn))
    upd = (-lr * rows_of(layout, ratio)) * u
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)
    return upd, m, v, p


def _check(g, ga, g2, m, v, p, w, layout: ParamLayout, state_dtype):
    shape = (layout.n_rows, LANE)
    for t in (g, ga, g2, m, v, p, w):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.device != g.device:
            raise ValueError(f"flat_vr_lamb: operands must be contiguous {shape} on {g.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if any(t.dtype != torch.float32 for t in (g, ga, g2, w)):
        raise TypeError("flat_vr_lamb: g, ga, g2 and w must be float32")
    sd = getattr(torch, state_dtype)
    if sd not in STATE_DTYPES or any(t.dtype != sd for t in (m, v, p)):
        raise TypeError(f"flat_vr_lamb: m, v, p must be {state_dtype} (one of {STATE_DTYPES})")
    capability = device_info(g.device.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"flat_vr_lamb: the kernel is built for sm_90a (Hopper), got {capability}")


def flat_vr_lamb(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                 b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """The full VR-LAMB step over the flat buffers: returns (upd, m', v', p').

    g, g2: the raw group moments (mean, sq_mean) the GSNR ratio reads; ga:
    the gradient the update applies (the clipped mean); w: the params;
    m, v, p in ``state_dtype``, updated in place; scal = (lr, bc1, bc2, bc3)
    as host floats."""
    if g.device.type == "cpu":
        return flat_vr_lamb_ref(g, ga, g2, m, v, p, w, scal, layout, b1=b1, b2=b2, b3=b3,
                                eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps,
                                state_dtype=state_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"flat_vr_lamb: no implementation for device {g.device}")
    _check(g, ga, g2, m, v, p, w, layout, state_dtype)
    lr, bc1, bc2, bc3 = (float(x) for x in scal[:4])
    meta = layout.device_meta(g.device)
    upd = torch.empty_like(g)
    acc = torch.empty((3, layout.leaf_slots), dtype=torch.float32, device=g.device)
    lib = _build.library("flat_update", _SIGNATURES)
    err = lib.flat_vr_lamb(
        g.data_ptr(), ga.data_ptr(), g2.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
        w.data_ptr(), upd.data_ptr(), meta["block_leaf_ids"].data_ptr(),
        meta["inv_sizes"].data_ptr(), acc.data_ptr(), layout.leaf_slots, layout.n_blocks,
        int(m.dtype == torch.bfloat16), lr, bc1, bc2, bc3, b1, b2, b3, eps, wd, gamma, gsnr_eps,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(err, "flat_vr_lamb")
    flat_vr_lamb.launches += 1
    return upd, m, v, p


flat_vr_lamb.launches = 0
