"""Flash-attention backward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention_bwd.py`` (the TPU kernel
``_fused_bwd_kernel`` behind ``flash_attention_bwd``, and its jnp replica
``attention_bwd_ref``).  The kernel is ``csrc/flash_attention_bwd.cu``; its
source note gives the design and bound.

Residual contract (from the forward, kernels/flash_attention.py): per query
row ``lse = m + log l`` (NEG_INF for rows with no valid key) and
``delta_i = <dO_i, O_i>``, both (B, H, Sq) f32.  With p recomputed as
``exp(scale * q k^T - lse)`` under the forward's mask:

    dv_j = sum_i p_ij dO_i
    dS_ij = p_ij (dO_i . v_j - delta_i) * scale
    dq_i = sum_j dS_ij k_j           dk_j = sum_i dS_ij q_i

GQA sums each kv head's gradient over its group.  ``flash_attention_bwd``
launches the kernel for a CUDA tensor (or raises) and computes
``attention_bwd_ref`` for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    BWD_HEAD_DIMS,
    NEG_INF,
    attention_mask,
    check_cuda_operands,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_bwd": [_P] * 13 + [_I] * 9 + [ctypes.c_float, _P],
}


def attention_bwd_ref(q, k, v, lse, delta, do, *, causal: bool, window: int = 0,
                      q_pos=None, k_pos=None, q_seg=None, k_seg=None):
    """Plain backward with the kernel's contract: (dq, dk, dv) in the input
    dtypes.  Port of ``repro/kernels/flash_attention_bwd.py::
    attention_bwd_ref``; omitted positions are the implicit layout."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d**-0.5
    if q_pos is None:
        q_pos = torch.arange(sq, dtype=torch.int32, device=q.device)[None]
        k_pos = torch.arange(skv, dtype=torch.int32, device=q.device)[None]
        q_seg = torch.zeros_like(q_pos)
        k_seg = torch.zeros_like(k_pos)
    qf = q.float().reshape(b, sq, kvh, g, d)
    dof = do.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    mask = attention_mask(q_pos, k_pos, q_seg, k_seg, causal=causal, window=window)[:, None, None]
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    s = torch.where(mask, s, NEG_INF)
    lse_r = lse.reshape(b, kvh, g, sq)
    # exact zeros off the mask: a fully masked row carries lse == NEG_INF,
    # where the unmasked exp overflows before the where kills it
    p = torch.where(mask, torch.exp(s - lse_r[..., None]), 0.0)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.reshape(b, kvh, g, sq)[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel(q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg, causal, window):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    check_cuda_operands("flash_attention_bwd", q, k, v, (q_pos, k_pos, q_seg, k_seg),
                        dims=BWD_HEAD_DIMS)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("flash_attention_bwd: dO must be a contiguous tensor like q")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous (B, H, Sq) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if k.shape[0] != b or q_pos.shape != (b, sq) or q_seg.shape != (b, sq) \
            or k_pos.shape != (b, skv) or k_seg.shape != (b, skv):
        raise ValueError("flash_attention_bwd: positions/segments must be (B, S) per side")
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)  # zeroed by the entry
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_attention_bwd", _SIGNATURES)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        do.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), q_seg.data_ptr(), k_seg.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, skv, h, kvh, d, int(q.dtype == torch.bfloat16), int(causal), int(window),
        d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd(q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg, *,
                        causal: bool, window: int = 0):
    """q/do: (B,Sq,H,D); k/v: (B,Skv,KV,D); lse/delta: (B,H,Sq) f32;
    positions/segments explicit (B, S) int32 -> (dq, dk, dv) in the input
    dtypes.  On a CUDA tensor this launches the kernel (bf16 or f32, D in
    {64, 128}; dq summed in f32) or raises; on a CPU tensor it computes the
    plain ``attention_bwd_ref``."""
    if q.device.type == "cuda":
        return _kernel(q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg, causal, window)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, lse, delta, do, causal=causal, window=window,
                                 q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)
    raise ValueError(f"flash_attention_bwd: no implementation for device {q.device}")


flash_attention_bwd.launches = 0
