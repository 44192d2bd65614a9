"""Flat gradient-moment carry: the CUDA kernels' wrappers and their plain
versions.

Counterpart of ``repro/kernels/flat_stats.py::flat_moments_accum``,
``::flat_moments_finalize`` (kernel bodies ``repro/kernels/grad_stats.py::
_accum_kernel`` / ``_finalize_kernel``), ``::flat_g_accum`` (its
``_g_accum_kernel``, the g-only carry of stale-GSNR steps) and
``::flat_pack_square`` (its ``_pack_square_kernel``, the all-reduce payload
of the data-parallel GSNR statistics) and ``::flat_vmap_moments`` (its
``_vmap_kernel``, the moments of the vmap stats method's gradient stack).
The kernels are ``csrc/flat_stats.cu``; its source note gives the design
and bound.

The first three work IN PLACE on the carry and return it (the reference
returns new buffers with the same values):

  flat_moments_accum(gs, g2s, g)     gs += g, g2s += g * g  (g cast to f32)
  flat_moments_finalize(gs, g2s, k)  gs, g2s *= 1/k  -> (mean, sq_mean)
  flat_g_accum(gs, g)                gs += g                (g cast to f32)
  flat_pack_square(g)                -> new (2, *g.shape) f32 [g; g * g]
  flat_vmap_moments(gstack, k)       -> new (mean, sq_mean) of a (k, ...)
                                        f32 stack, summed over j in order

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
computes the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.backend import HOPPER, device_info
from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flat_moments_accum": [_P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    "flat_moments_finalize": [_P, _P, ctypes.c_float, ctypes.c_longlong, _I, _P],
    "flat_g_accum": [_P, _P, ctypes.c_longlong, _I, _I, _P],
    "flat_pack_square": [_P, _P, ctypes.c_longlong, _I, _P],
    "flat_vmap_moments": [_P, _P, _P, _I, ctypes.c_float, ctypes.c_longlong, _I, _P],
}


def inv_k(k) -> float:
    """1/k as the reference computes it: an f32 division."""
    return float(np.float32(1.0) / np.float32(k))


def moments_accum_ref(gs, g2s, g):
    """Plain version of the accumulate, in place."""
    gf = g.float()
    gs.add_(gf)
    g2s.add_(gf * gf)
    return gs, g2s


def g_accum_ref(gs, g):
    """Plain version of the g-only accumulate, in place."""
    return gs.add_(g.float())


def moments_finalize_ref(gs, g2s, k):
    """Plain version of the finalize, in place: (mean, sq_mean)."""
    inv = inv_k(k)
    gs.mul_(inv)
    g2s.mul_(inv)
    return gs, g2s


def pack_square_ref(g):
    """Plain version of the pack: a new (2, *g.shape) f32 [g; g * g]."""
    gf = g.float()
    return torch.stack((gf, gf * gf))


def vmap_moments_ref(gstack, k):
    """Plain version of the stack's moments: for each element the k slices
    summed in order in f32, then times f32(1/k) -> (mean, sq_mean)."""
    if gstack.shape[0] != k:
        raise ValueError(f"vmap_moments: stack of {gstack.shape[0]} slices, k={k}")
    s = torch.zeros(gstack.shape[1:], dtype=torch.float32, device=gstack.device)
    s2 = torch.zeros_like(s)
    for j in range(k):
        x = gstack[j].float()
        s += x
        s2 += x * x
    inv = inv_k(k)
    return s.mul_(inv), s2.mul_(inv)


def _check(name, carry, others):
    for t in (*carry, *others):
        if t.device != carry[0].device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and on {carry[0].device}")
        if t.shape != carry[0].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(carry[0].shape)}")
    if any(t.dtype != torch.float32 for t in carry):
        raise TypeError(f"{name}: the carry must be float32")
    if carry[0].numel() % 4:
        raise ValueError(f"{name}: {carry[0].numel()} elements is not a multiple of 4")
    capability = device_info(carry[0].device.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a (Hopper), got {capability}")


def flat_moments_accum(gs: torch.Tensor, g2s: torch.Tensor, g: torch.Tensor):
    """One microbatch into the (g_sum, g2_sum) carry, in place; g is f32 or
    bf16 of the same shape.  Returns (gs, g2s)."""
    if gs.device.type == "cpu":
        return moments_accum_ref(gs, g2s, g)
    if gs.device.type != "cuda":
        raise ValueError(f"flat_moments_accum: no implementation for device {gs.device}")
    launch_accum("flat_moments_accum", gs, g2s, g)
    flat_moments_accum.launches += 1
    return gs, g2s


def launch_accum(name, gs, g2s, g):
    """Launch the accumulate kernel on CUDA tensors (checked), uncounted:
    the wrappers that call it count their own launches."""
    _check(name, (gs, g2s), (g,))
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: g must be float32 or bfloat16, got {g.dtype}")
    lib = _build.library("flat_stats", _SIGNATURES)
    err = lib.flat_moments_accum(
        gs.data_ptr(), g2s.data_ptr(), g.data_ptr(), gs.numel(), int(g.dtype == torch.bfloat16),
        device_info(gs.device.index)[1], torch.cuda.current_stream(gs.device).cuda_stream,
    )
    _build.check(err, name)


def flat_g_accum(gs: torch.Tensor, g: torch.Tensor):
    """One microbatch into the g-only carry, in place; g is f32 or bf16 of
    the same shape.  Returns gs."""
    if gs.device.type == "cpu":
        return g_accum_ref(gs, g)
    if gs.device.type != "cuda":
        raise ValueError(f"flat_g_accum: no implementation for device {gs.device}")
    _check("flat_g_accum", (gs,), (g,))
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flat_g_accum: g must be float32 or bfloat16, got {g.dtype}")
    lib = _build.library("flat_stats", _SIGNATURES)
    err = lib.flat_g_accum(
        gs.data_ptr(), g.data_ptr(), gs.numel(), int(g.dtype == torch.bfloat16),
        device_info(gs.device.index)[1], torch.cuda.current_stream(gs.device).cuda_stream,
    )
    _build.check(err, "flat_g_accum")
    flat_g_accum.launches += 1
    return gs


def flat_moments_finalize(gs: torch.Tensor, g2s: torch.Tensor, k):
    """The terminal /k of both carries, in place: returns (mean, sq_mean),
    the same tensors as (gs, g2s)."""
    if gs.device.type == "cpu":
        return moments_finalize_ref(gs, g2s, k)
    if gs.device.type != "cuda":
        raise ValueError(f"flat_moments_finalize: no implementation for device {gs.device}")
    launch_finalize("flat_moments_finalize", gs, g2s, k)
    flat_moments_finalize.launches += 1
    return gs, g2s


def launch_finalize(name, gs, g2s, k):
    """Launch the finalize kernel on CUDA tensors (checked), uncounted."""
    _check(name, (gs, g2s), ())
    lib = _build.library("flat_stats", _SIGNATURES)
    err = lib.flat_moments_finalize(
        gs.data_ptr(), g2s.data_ptr(), inv_k(k), gs.numel(), device_info(gs.device.index)[1],
        torch.cuda.current_stream(gs.device).cuda_stream,
    )
    _build.check(err, name)


def flat_pack_square(g: torch.Tensor) -> torch.Tensor:
    """The (2, *g.shape) f32 payload [g; g * g] from one read of the f32
    flat gradient g: the buffer the data-parallel step all-reduces."""
    if g.device.type == "cpu":
        return pack_square_ref(g)
    if g.device.type != "cuda":
        raise ValueError(f"flat_pack_square: no implementation for device {g.device}")
    _check("flat_pack_square", (g,), ())
    out = torch.empty((2, *g.shape), dtype=torch.float32, device=g.device)
    lib = _build.library("flat_stats", _SIGNATURES)
    err = lib.flat_pack_square(g.data_ptr(), out.data_ptr(), g.numel(),
                               device_info(g.device.index)[1],
                               torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "flat_pack_square")
    flat_pack_square.launches += 1
    return out


def flat_vmap_moments(gstack: torch.Tensor, k: int):
    """(k, n_rows, LANE) f32 gradient stack -> new flat (mean, sq_mean) f32
    buffers: one launch (the vmap stats method's reduction)."""
    if gstack.device.type == "cpu":
        return vmap_moments_ref(gstack, k)
    if gstack.device.type != "cuda":
        raise ValueError(f"flat_vmap_moments: no implementation for device {gstack.device}")
    if gstack.shape[0] != k:
        raise ValueError(f"flat_vmap_moments: stack of {gstack.shape[0]} slices, k={k}")
    _check("flat_vmap_moments", (gstack,), ())
    mean = torch.empty(gstack.shape[1:], dtype=torch.float32, device=gstack.device)
    sq = torch.empty_like(mean)
    lib = _build.library("flat_stats", _SIGNATURES)
    err = lib.flat_vmap_moments(gstack.data_ptr(), mean.data_ptr(), sq.data_ptr(), k, inv_k(k),
                                mean.numel(), device_info(gstack.device.index)[1],
                                torch.cuda.current_stream(gstack.device).cuda_stream)
    _build.check(err, "flat_vmap_moments")
    flat_vmap_moments.launches += 1
    return mean, sq


flat_moments_accum.launches = 0
flat_moments_finalize.launches = 0
flat_g_accum.launches = 0
flat_pack_square.launches = 0
flat_vmap_moments.launches = 0
