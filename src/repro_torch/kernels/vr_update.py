"""Per-leaf GSNR scale (K18): the CUDA kernel's wrapper and its plain version,
and the per-leaf helpers the other per-leaf kernels share.

Counterpart of ``repro/kernels/vr_update.py::vr_scale`` (TPU kernel
``_kernel``): the VR pipeline (variance -> GSNR -> normalize -> clip ->
scale) on ONE parameter leaf.  The flat single-launch form over the whole
parameter set is ``flat_update.py::flat_vr_scale``; this one is the
per-leaf dispatch.  The kernel is ``csrc/vr_leaf.cu``; its source note
gives the design and bound.

As in the reference, the scalar ``inv_mean = 1 / max(mean(r_raw), 1e-30)``
over the leaf's unpadded elements comes from a plain prepass
(``inv_mean_r``), and every operand is cast to f32 and zero-padded to the
reference's (rows, 128) layout (``pad2d``) before the kernel; the outputs
are unpadded views.  On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it computes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend import HOPPER, device_info
from repro_torch.core.layout import LANE, SUBLANE
from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "leaf_vr_scale": [_P] * 6 + [ctypes.c_longlong, _F, _F, _I, _P],
    "leaf_vr_adam": [_P] * 13 + [ctypes.c_longlong] + [_F] * 10 + [_I, _I, _P],
    "leaf_vr_lars": [_P] * 7 + [ctypes.c_longlong, _F, _F, _F, _I, _P],
}


def padded_rows(n: int) -> int:
    """Rows of the (rows, 128) f32 layout of an n-element leaf: ceil(n/128)
    rounded up to the f32 sublane multiple (the reference's)."""
    rows = -(-n // LANE)
    return -(-rows // SUBLANE) * SUBLANE


def pad2d(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a (padded_rows, 128) f32 tensor with a zero tail (a view
    when it already is f32, contiguous and whole rows)."""
    n = x.numel()
    flat = x.reshape(-1).float()
    pad = padded_rows(n) * LANE - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, LANE)


def unpad(x2d: torch.Tensor, shape) -> torch.Tensor:
    """The first prod(shape) elements of a padded buffer, as ``shape`` (a
    view)."""
    n = 1
    for d in shape:
        n *= d
    return x2d.reshape(-1)[:n].reshape(shape)


def inv_mean_r(g, g2, eps) -> torch.Tensor:
    """0-dim f32: 1 / max(mean of r_raw over the leaf, 1e-30), the plain
    prepass of the reference's per-leaf kernels."""
    gf = g.reshape(-1).float()
    var = torch.clamp(g2.reshape(-1).float() - gf * gf, min=0.0)
    return 1.0 / torch.clamp(torch.mean(gf * gf / (var + eps)), min=1e-30)


def clip_r(g2d, g22d, inv_mean, gamma, eps):
    """Plain: r = clip(g^2 / (max(g2 - g^2, 0) + eps) * inv_mean, gamma, 1)."""
    var = torch.clamp(g22d - g2d * g2d, min=0.0)
    return torch.clamp((g2d * g2d) / (var + eps) * inv_mean, gamma, 1.0)


def check_leaf(name, ops) -> None:
    """Raise unless the padded operands are one CUDA device's, f32 and
    contiguous, and the card is Hopper."""
    first = ops[0]
    for t in ops:
        if t.device != first.device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != first.shape:
            raise ValueError(f"{name}: operands must be contiguous f32 {tuple(first.shape)} on "
                             f"{first.device}")
    capability = device_info(first.device.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a (Hopper), got {capability}")


def stream_args(t: torch.Tensor):
    """(SM count, current stream) of ``t``'s card for a launch."""
    return device_info(t.device.index)[1], torch.cuda.current_stream(t.device).cuda_stream


def vr_scale_ref(g, g2, gamma: float, eps: float, g_apply=None):
    """Plain version of ``vr_scale``: (sg, r) f32 in ``g``'s shape."""
    ga = g if g_apply is None else g_apply
    inv = inv_mean_r(g, g2, eps)
    r = clip_r(g.float(), g2.float(), inv, gamma, eps)
    return r * ga.float(), r


def vr_scale(g, g2, gamma: float, eps: float, g_apply=None):
    """Fused (scaled_grad, r) for one tensor, both f32 in ``g``'s shape.  r
    derives from the raw group moments (g, g2); it multiplies ``g_apply``
    (the gradient entering the update; None means g)."""
    ga = g if g_apply is None else g_apply
    if g.device.type == "cpu":
        return vr_scale_ref(g, g2, gamma, eps, g_apply)
    if g.device.type != "cuda":
        raise ValueError(f"vr_scale: no implementation for device {g.device}")
    ops = [pad2d(t) for t in (g, ga, g2)]
    check_leaf("vr_scale", ops)
    inv = inv_mean_r(g, g2, eps)
    sg, r = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_vr_scale(*(t.data_ptr() for t in ops), inv.data_ptr(), sg.data_ptr(),
                            r.data_ptr(), sg.numel(), gamma, eps, *stream_args(sg))
    _build.check(err, "leaf_vr_scale")
    vr_scale.launches += 1
    return unpad(sg, g.shape), unpad(r, g.shape)


vr_scale.launches = 0
