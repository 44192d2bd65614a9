"""Per-leaf GSNR scale (K18): the CUDA kernel's wrapper and its plain version,
and the per-leaf helpers the other per-leaf kernels share.

Counterpart of ``repro/kernels/vr_update.py::vr_scale`` (TPU kernel
``_kernel``): the VR pipeline (variance -> GSNR -> normalize -> clip ->
scale) on ONE parameter leaf.  The flat single-launch form over the whole
parameter set is ``flat_update.py::flat_vr_scale``; this one is the
per-leaf dispatch.  The kernel is ``csrc/vr_leaf.cu``; its source note
gives the design and bound.

The scalar ``inv_mean = 1 / max(mean(r_raw), 1e-30)`` over the leaf's
unpadded elements, which the reference computes in jnp before its kernel,
comes from a kernel of its own here (``leaf_inv_mean``: one launch that
reads g and g2 as they are and leaves the 0-dim result on the card, where
the step kernels read it).  Every operand of a step kernel is cast to f32
and zero-padded to the reference's (rows, 128) layout (``pad2d``) before
it; the outputs are unpadded views.  On a CUDA tensor each wrapper launches
its kernel or raises; on a CPU tensor it computes the plain version
(``inv_mean_r`` for the prepass).
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
    "leaf_vr_adam": [_P] * 15 + [ctypes.c_longlong] + [_F] * 10 + [_I, _I, _P],
    "leaf_vr_lars": [_P] * 9 + [ctypes.c_longlong, _F, _F, _F, _I, _P],
    "leaf_inv_mean": [_P, _P, ctypes.c_longlong, _I, _I, _F, _P, _I, _P, _P, _P],
}
INV_MEAN_BLOCKS_PER_SM = 2  # the prepass's grid cap: its f64 partials, one a block
STEP_BLOCKS_PER_SM = 16  # the step kernels' grid cap (vr_leaf.cu::leaf_grid)


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
    version of ``leaf_inv_mean`` (the reference's jnp prepass)."""
    gf = g.reshape(-1).float()
    var = torch.clamp(g2.reshape(-1).float() - gf * gf, min=0.0)
    return 1.0 / torch.clamp(torch.mean(gf * gf / (var + eps)), min=1e-30)


_counters = {}  # (device index, stream, kind) -> a u32 block counter, left at 0


def zeroed_counter(device, stream, kind: str) -> torch.Tensor:
    """The u32 block counter of ``kind``'s kernels on (device, stream):
    zeroed once, and every launch leaves it at 0."""
    key = (device.index, stream, kind)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def norm_scratch(t: torch.Tensor):
    """(partials, ticket, acc) of a K20/K21 launch on ``t``'s card: the f64
    slots of the norm sums' two-level combine (two a block), its ticket
    and the two f32 sums."""
    n_sm, stream = stream_args(t)
    partials = torch.empty(2 * STEP_BLOCKS_PER_SM * n_sm, dtype=torch.float64, device=t.device)
    acc = torch.empty(2, dtype=torch.float32, device=t.device)
    return partials, zeroed_counter(t.device, stream, "norms"), acc


def leaf_inv_mean(g, g2, eps) -> torch.Tensor:
    """0-dim f32 inv_mean = 1 / max(mean of r_raw over the leaf, 1e-30) of
    one leaf, g and g2 f32 or bf16 of the same size: one kernel launch on a
    CUDA tensor (the result stays on the card), the plain version on a CPU
    tensor."""
    if g.device.type == "cpu":
        return inv_mean_r(g, g2, eps)
    if g.device.type != "cuda":
        raise ValueError(f"leaf_inv_mean: no implementation for device {g.device}")
    if g2.device != g.device or g2.numel() != g.numel() or g.numel() == 0:
        raise ValueError(f"leaf_inv_mean: g {tuple(g.shape)} on {g.device} and g2 "
                         f"{tuple(g2.shape)} on {g2.device} must be one non-empty size on one card")
    for t in (g, g2):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"leaf_inv_mean: g and g2 must be float32 or bfloat16, got {t.dtype}")
    capability = device_info(g.device.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"leaf_inv_mean: the kernel is built for sm_90a (Hopper), got "
                           f"{capability}")
    gf, g2f = g.reshape(-1), g2.reshape(-1)
    n_sm, stream = stream_args(g)
    partials = torch.empty(INV_MEAN_BLOCKS_PER_SM * n_sm, dtype=torch.float64, device=g.device)
    counter = zeroed_counter(g.device, stream, "inv_mean")
    inv = torch.empty((), dtype=torch.float32, device=g.device)
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_inv_mean(gf.data_ptr(), g2f.data_ptr(), gf.numel(),
                            int(g.dtype == torch.bfloat16), int(g2.dtype == torch.bfloat16), eps,
                            partials.data_ptr(), partials.numel(), counter.data_ptr(),
                            inv.data_ptr(), stream)
    _build.check(err, "leaf_inv_mean")
    leaf_inv_mean.launches += 1
    return inv


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
    inv = leaf_inv_mean(g, g2, eps)
    sg, r = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    lib = _build.library("vr_leaf", SIGNATURES)
    err = lib.leaf_vr_scale(*(t.data_ptr() for t in ops), inv.data_ptr(), sg.data_ptr(),
                            r.data_ptr(), sg.numel(), gamma, eps, *stream_args(sg))
    _build.check(err, "leaf_vr_scale")
    vr_scale.launches += 1
    return unpad(sg, g.shape), unpad(r, g.shape)


leaf_inv_mean.launches = 0
vr_scale.launches = 0
