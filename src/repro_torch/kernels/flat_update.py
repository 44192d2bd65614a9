"""Flat VR optimizer updates: the CUDA kernels' wrappers and their plain
versions.

Counterpart of ``repro/kernels/flat_update.py`` (the TPU kernels
``_vr_scale_kernel``, ``_vr_adam_kernel``, ``_vr_lamb_kernel`` and
``_vr_lars_kernel``; bodies ``_raw_r``, ``_inv_mean_r``, ``_adam_math`` and
``_trust_ratio``).  The kernels are ``csrc/flat_update.cu``; its source
note gives the design and bound.  Every entry works on the ``(n_rows, 128)``
f32 buffers of a ParamLayout:

  flat_vr_scale(g, ga, g2, ...)               -> (sg, r)            2 launches
  flat_vr_adam(g, ga, g2, m, v, p, w, ...)    -> (upd, m', v', p')  2 launches
  flat_vr_lamb(g, ga, g2, m, v, p, w, ...)    -> (upd, m', v', p')  3 launches
  flat_vr_lars(g, ga, g2, m, w, ...)          -> (upd, m')          3 launches

g, g2 are the raw group moments (mean, sq_mean) the GSNR ratio reads; ga
the gradient the update applies (the clipped mean); w the params.  The
state (m, v, p in ``state_dtype``; LARS's m in f32) is written IN PLACE and
returned (the reference returns new buffers with the same values); upd, sg
and r are new f32 buffers.  On a CUDA tensor each entry launches its
kernels or raises; on a CPU tensor it computes the plain version
(``*_ref``).  ``<entry>.launches`` counts the calls that launched.
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
_ADAM_ARGS = [_P] * 12 + [_I, _I, _I] + [_F] * 11 + [_P]
_SIGNATURES = {
    "flat_vr_lamb": _ADAM_ARGS,
    "flat_vr_adam": _ADAM_ARGS,
    "flat_vr_scale": [_P] * 9 + [_I, _I] + [_F, _F] + [_P],
    "flat_vr_lars": [_P] * 10 + [_I, _I] + [_F] * 6 + [_P],
}
STATE_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def raw_r(g, g2, gsnr_eps: float) -> torch.Tensor:
    """r = g^2 / (max(g2 - g^2, 0) + eps), in f32."""
    g, g2 = g.float(), g2.float()
    gg = g * g
    return gg / (torch.clamp(g2 - gg, min=0.0) + gsnr_eps)


def gsnr_ratio(g, g2, layout: ParamLayout, gamma: float, gsnr_eps: float) -> torch.Tensor:
    """clip(r_raw / mean_leaf(r_raw), gamma, 1) over the flat buffer; the
    mean is over each leaf's true size (the zero tail adds nothing)."""
    r_raw = raw_r(g, g2, gsnr_eps)
    inv = layout.device_meta(g.device)["inv_sizes"][: layout.n_leaves]
    inv_mean = 1.0 / torch.clamp(leaf_sums(layout, r_raw) * inv, min=1e-30)
    return torch.clamp(r_raw * rows_of(layout, inv_mean), gamma, 1.0)


def _adam_ref(g, ga, g2, m, v, p, w, scal, layout, b1, b2, b3, eps, wd, gamma, gsnr_eps):
    """The element-wise VR-Adam chain: (u = direction + wd w, m', v', p')."""
    return adam_chain(gsnr_ratio(g, g2, layout, gamma, gsnr_eps), ga, m, v, p, w, scal,
                      b1, b2, b3, eps, wd)


def adam_chain(r, ga, m, v, p, w, scal, b1, b2, b3, eps, wd):
    """The VR-Adam chain from the clipped GSNR ratio r: (u = direction +
    wd w, m', v', p') in f32; scal = (lr, bc1, bc2, bc3)."""
    _, bc1, bc2, bc3 = (float(x) for x in scal[:4])
    p_new = b3 * p.float() + (1.0 - b3) * r
    ghat = (p_new / bc3) * ga.float()
    m_new = b1 * m.float() + (1.0 - b1) * ghat
    v_new = b2 * v.float() + (1.0 - b2) * ghat * ghat
    del ghat
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * w.float()
    return u, m_new, v_new, p_new


def _store(dst, *news):
    for d, n in zip(dst, news):
        d.copy_(n)
    return dst


def flat_vr_scale_ref(g, ga, g2, layout: ParamLayout, *, gamma, eps):
    """Plain version of ``flat_vr_scale``: (r * ga, r)."""
    r = gsnr_ratio(g, g2, layout, gamma, eps)
    return r * ga.float(), r


def flat_vr_adam_ref(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                     b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """Plain version of ``flat_vr_adam``; m, v, p are updated in place."""
    u, *new = _adam_ref(g, ga, g2, m, v, p, w, scal, layout, b1, b2, b3, eps, wd, gamma,
                        gsnr_eps)
    return (-float(scal[0]) * u, *_store((m, v, p), *new))


def flat_vr_lamb_ref(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                     b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """Plain version of ``flat_vr_lamb`` (the same three phases in torch
    over the flat buffers); m, v, p are updated in place."""
    u, *new = _adam_ref(g, ga, g2, m, v, p, w, scal, layout, b1, b2, b3, eps, wd, gamma,
                        gsnr_eps)
    wf = w.float()
    un = torch.sqrt(leaf_sums(layout, u * u))
    pn = torch.sqrt(leaf_sums(layout, wf * wf))
    ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12), torch.ones_like(pn))
    upd = (-float(scal[0]) * rows_of(layout, ratio)) * u
    return (upd, *_store((m, v, p), *new))


def flat_vr_lars_ref(g, ga, g2, m, w, scal: Sequence[float], layout: ParamLayout, *,
                     mu, wd, trust, eps):
    """Plain version of ``flat_vr_lars``; m is updated in place."""
    lr, gamma = (float(x) for x in scal[:2])
    wf = w.float()
    u = gsnr_ratio(g, g2, layout, gamma, eps) * ga.float() + wd * wf
    un = torch.sqrt(leaf_sums(layout, u * u))
    pn = torch.sqrt(leaf_sums(layout, wf * wf))
    ratio = torch.where((pn > 0) & (un > 0), trust * pn / (un + 1e-12), torch.ones_like(pn))
    m.copy_(mu * m + rows_of(layout, ratio) * u)
    return -lr * m, m


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, layout: ParamLayout, f32s, state=(), state_dtype=torch.float32):
    """Raise unless every operand is a contiguous (n_rows, 128) tensor on one
    Hopper card, ``f32s`` float32 and ``state`` of ``state_dtype``."""
    shape, dev = (layout.n_rows, LANE), f32s[0].device
    for t in (*f32s, *state):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: operands must be contiguous {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise TypeError(f"{name}: the gradients, moments and params must be float32")
    if state_dtype not in STATE_DTYPES or any(t.dtype != state_dtype for t in state):
        raise TypeError(f"{name}: the state must be {state_dtype} (one of {STATE_DTYPES})")
    capability = device_info(dev.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a (Hopper), got {capability}")


def _device(name, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain version)."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cuda"
    raise ValueError(f"{name}: no implementation for device {t.device}")


def _meta(layout: ParamLayout, dev, n_acc: int):
    """The layout's block_leaf_ids and inv_sizes on ``dev``, a new f32
    (n_acc, leaf_slots) scratch for the per-leaf sums (Σr; with 3 rows also
    Σu² and Σw²), and a new f64 scratch for the blocks' partial sums and the
    tickets of the last-block combines: n_blocks + 1 for Σr alone, 2 n_blocks
    + 1 with the norm sums (the entry zeroes the tickets; the combines write
    every accumulator slot)."""
    meta = layout.device_meta(dev)
    acc = torch.empty((n_acc, layout.leaf_slots), dtype=torch.float32, device=dev)
    n_sums = 2 if n_acc == 3 else 1
    partials = torch.empty(n_sums * layout.n_blocks + 1, dtype=torch.float64, device=dev)
    return meta["block_leaf_ids"], meta["inv_sizes"], acc, partials


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _adam_call(name, g, ga, g2, m, v, p, w, scal, layout, hyper, state_dtype, n_acc):
    """Launch K6 (``flat_vr_adam``, n_acc 1) or K5 (``flat_vr_lamb``, n_acc
    3) uncounted: (upd, the (n_acc, leaf_slots) per-leaf sums of r_raw and,
    for K5, u² and w² that the step used)."""
    sd = getattr(torch, state_dtype)
    _check(name, layout, (g, ga, g2, w), (m, v, p), sd)
    lr, bc1, bc2, bc3 = (float(x) for x in scal[:4])
    ids, inv, acc, partials = _meta(layout, g.device, n_acc)
    upd = torch.empty_like(g)
    h = hyper
    err = getattr(_build.library("flat_update", _SIGNATURES), name)(
        g.data_ptr(), ga.data_ptr(), g2.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
        w.data_ptr(), upd.data_ptr(), ids.data_ptr(), inv.data_ptr(), acc.data_ptr(),
        partials.data_ptr(), layout.leaf_slots, layout.n_blocks, int(sd == torch.bfloat16), lr,
        bc1, bc2, bc3, h["b1"], h["b2"], h["b3"], h["eps"], h["wd"], h["gamma"], h["gsnr_eps"],
        _stream(g.device),
    )
    _build.check(err, name)
    return upd, acc


def _lars_call(g, ga, g2, m, w, scal, layout, mu, wd, trust, eps):
    """Launch K7 uncounted: (upd, the (3, leaf_slots) per-leaf sums of
    r_raw, u² and w² that the step used)."""
    _check("flat_vr_lars", layout, (g, ga, g2, m, w))
    lr, gamma = (float(x) for x in scal[:2])
    ids, inv, acc, partials = _meta(layout, g.device, 3)
    upd = torch.empty_like(g)
    err = _build.library("flat_update", _SIGNATURES).flat_vr_lars(
        g.data_ptr(), ga.data_ptr(), g2.data_ptr(), m.data_ptr(), w.data_ptr(), upd.data_ptr(),
        ids.data_ptr(), inv.data_ptr(), acc.data_ptr(), partials.data_ptr(), layout.leaf_slots,
        layout.n_blocks, lr, gamma, mu, wd, trust, eps, _stream(g.device),
    )
    _build.check(err, "flat_vr_lars")
    return upd, acc


def flat_vr_scale(g, ga, g2, layout: ParamLayout, *, gamma, eps):
    """The GSNR-scaled gradient over the flat buffers: returns (r * ga, r).

    r = clip(r_raw / mean_leaf(r_raw), gamma, 1) with r_raw from (g, g2)."""
    if not _device("flat_vr_scale", g):
        return flat_vr_scale_ref(g, ga, g2, layout, gamma=gamma, eps=eps)
    _check("flat_vr_scale", layout, (g, ga, g2))
    ids, inv, acc, partials = _meta(layout, g.device, 1)
    sg, r = torch.empty_like(g), torch.empty_like(g)
    err = _build.library("flat_update", _SIGNATURES).flat_vr_scale(
        g.data_ptr(), ga.data_ptr(), g2.data_ptr(), sg.data_ptr(), r.data_ptr(), ids.data_ptr(),
        inv.data_ptr(), acc.data_ptr(), partials.data_ptr(), layout.leaf_slots, layout.n_blocks,
        gamma, eps, _stream(g.device),
    )
    _build.check(err, "flat_vr_scale")
    flat_vr_scale.launches += 1
    return sg, r


def flat_vr_adam(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                 b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """The full VR-Adam step over the flat buffers: returns (upd, m', v', p')
    with upd = -lr (direction + wd w); scal = (lr, bc1, bc2, bc3) as host
    floats; m, v, p in ``state_dtype``, updated in place."""
    hyper = dict(b1=b1, b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps)
    if not _device("flat_vr_adam", g):
        return flat_vr_adam_ref(g, ga, g2, m, v, p, w, scal, layout, state_dtype=state_dtype,
                                **hyper)
    upd, _ = _adam_call("flat_vr_adam", g, ga, g2, m, v, p, w, scal, layout, hyper, state_dtype,
                        1)
    flat_vr_adam.launches += 1
    return upd, m, v, p


def flat_vr_lamb(g, ga, g2, m, v, p, w, scal: Sequence[float], layout: ParamLayout, *,
                 b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """The full VR-LAMB step over the flat buffers: returns (upd, m', v', p')
    with upd = -lr ratio_leaf (direction + wd w); scal = (lr, bc1, bc2, bc3)
    as host floats; m, v, p in ``state_dtype``, updated in place."""
    hyper = dict(b1=b1, b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps)
    if not _device("flat_vr_lamb", g):
        return flat_vr_lamb_ref(g, ga, g2, m, v, p, w, scal, layout, state_dtype=state_dtype,
                                **hyper)
    upd, _ = _adam_call("flat_vr_lamb", g, ga, g2, m, v, p, w, scal, layout, hyper, state_dtype,
                        3)
    flat_vr_lamb.launches += 1
    return upd, m, v, p


def flat_vr_lars(g, ga, g2, m, w, scal: Sequence[float], layout: ParamLayout, *,
                 mu, wd, trust, eps):
    """The full VR-LARS step over the flat buffers: returns (upd, m') with
    m' = mu m + ratio_leaf (r ga + wd w), upd = -lr m'; scal = (lr, gamma)
    as host floats; m f32, updated in place."""
    if not _device("flat_vr_lars", g):
        return flat_vr_lars_ref(g, ga, g2, m, w, scal, layout, mu=mu, wd=wd, trust=trust,
                                eps=eps)
    upd, _ = _lars_call(g, ga, g2, m, w, scal, layout, mu, wd, trust, eps)
    flat_vr_lars.launches += 1
    return upd, m


flat_vr_scale.launches = 0
flat_vr_adam.launches = 0
flat_vr_lamb.launches = 0
flat_vr_lars.launches = 0
