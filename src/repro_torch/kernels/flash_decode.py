"""Decode attention over the paged KV cache: split-KV CUDA kernels, their
wrappers and plain versions.

Counterpart of ``repro/kernels/flash_decode.py::flash_decode``, which on
the TPU runs the flash-attention kernel with Sq = L decode lanes against
Skv = C cache slots.  On Hopper it is two kernels (``csrc/flash_decode.cu``):
``flash_decode_split`` computes partial (m, l, acc) per cache chunk and
``flash_decode_combine`` merges them.

EXPLICIT-SEGMENT CONTRACT: q_pos, k_pos, q_seg and k_seg are all required.
The cache's kseg carries row-global segment numbering and a decode query
stream is a different position stream from the cache, so derived ordinals
cannot align.  Slot order is arbitrary: the mask reads only the values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend import device_info
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    attention_fwd_ref,
    as_rows,
    attention_mask,
    check_cuda_operands,
)

TILE = 64  # cache slots per kernel tile; a chunk is a whole number of tiles
ROWS_PER_BLOCK = 16  # query rows (G * L of one kv head) per split block

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_decode_split": [_P] * 10 + [_I] * 9 + [ctypes.c_float, _I, _I, _P],
    "flash_decode_combine": [_P] * 4 + [_I] * 6 + [_P],
}


def decode_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal=True, window=0):
    """Plain paged-decode attention (port of ``ref.decode_attention_ref``):
    attention with every operand explicit; idle lanes and empty slots are
    masked and a lane with no reachable slot gives exactly 0."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)[0]


def split_plan(b: int, kvh: int, rows: int, c: int, n_sm: int):
    """(chunk, n_splits): cut C slots into chunks of whole tiles so that the
    split kernel's B * KV * row_groups * n_splits blocks cover the n_sm SMs
    at least twice (or every tile is its own chunk)."""
    tiles = -(-c // TILE)
    blocks = b * kvh * -(-rows // ROWS_PER_BLOCK)
    want = -(-2 * n_sm // blocks)
    chunk = max(1, tiles // want) * TILE  # rounding down keeps >= want splits
    return chunk, -(-c // chunk)


def decode_split_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal, window, chunk):
    """Plain version of the split kernel: per chunk of ``chunk`` slots the
    running max m, denominator l (B,H,L,NS) and unnormalised accumulator
    acc (B,H,L,NS,D), all f32; a chunk with no valid slot has m = NEG_INF,
    l = 0, acc = 0."""
    b, lanes, h, d = q.shape
    c, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    ns = -(-c // chunk)
    pad = ns * chunk - c
    kf, vf = k.float(), v.float()
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        k_seg = torch.nn.functional.pad(k_seg, (0, pad), value=-2)
    qh = q.reshape(b, lanes, kvh, g, d).float() * d**-0.5
    kc = kf.reshape(b, ns, chunk, kvh, d)
    vc = vf.reshape(b, ns, chunk, kvh, d)
    s = torch.einsum("blkgd,bnckd->bkgnlc", qh, kc)
    mask = attention_mask(q_pos, k_pos, q_seg, k_seg, causal=causal, window=window)
    mask = mask.reshape(b, lanes, ns, chunk).permute(0, 2, 1, 3)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnlc,bnckd->bkgnld", p, vc)
    # (B, KV, G, NS, L, ...) -> (B, H, L, NS, ...)
    m = m.permute(0, 1, 2, 4, 3).reshape(b, h, lanes, ns)
    l = l.permute(0, 1, 2, 4, 3).reshape(b, h, lanes, ns)
    acc = acc.permute(0, 1, 2, 4, 3, 5).reshape(b, h, lanes, ns, d)
    return m.contiguous(), l.contiguous(), acc.contiguous()


def decode_combine_ref(m, l, acc, dtype):
    """Plain version of the combine kernel: merge (B,H,L,NS) partials into
    out (B,L,H,D) in ``dtype``; exactly 0 where every split has l == 0."""
    mmax = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mmax)
    lsum = (w * l).sum(dim=-1)
    o = (w[..., None] * acc).sum(dim=-2)
    out = torch.where(lsum[..., None] > 0, o / lsum.clamp_min(1e-30)[..., None], 0.0)
    return out.permute(0, 2, 1, 3).to(dtype)


def flash_decode_split(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal, window, chunk):
    """Partials (m, l, acc) of the split kernel; its plain version on CPU."""
    if q.device.type == "cpu":
        return decode_split_ref(q, k, v, q_pos, k_pos, q_seg, k_seg,
                                causal=causal, window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_split: no implementation for device {q.device}")
    b, lanes, h, d = q.shape
    c, kvh = k.shape[1], k.shape[2]
    check_cuda_operands("flash_decode_split", q, k, v, (q_pos, k_pos, q_seg, k_seg))
    if k.shape[0] != b or q_pos.shape != (b, lanes) or q_seg.shape != (b, lanes) \
            or k_pos.shape != (b, c) or k_seg.shape != (b, c):
        raise ValueError("flash_decode_split: q_pos/q_seg must be (B, L), k_pos/k_seg (B, C)")
    if chunk <= 0 or chunk % TILE:
        raise ValueError(f"flash_decode_split: chunk must be a positive multiple of {TILE}")
    ns = -(-c // chunk)
    m = torch.empty((b, h, lanes, ns), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, lanes, ns, d), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        q_seg.data_ptr(), k_seg.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        b, lanes, c, h, kvh, d, int(q.dtype == torch.bfloat16), int(causal), int(window),
        d**-0.5, chunk, ns, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_decode_split")
    flash_decode_split.launches += 1
    return m, l, acc


def flash_decode_combine(m, l, acc, dtype):
    """out (B,L,H,D) from the split partials; its plain version on CPU."""
    if m.device.type == "cpu":
        return decode_combine_ref(m, l, acc, dtype)
    if m.device.type != "cuda":
        raise ValueError(f"flash_decode_combine: no implementation for device {m.device}")
    b, h, lanes, ns = m.shape
    d = acc.shape[-1]
    for t in (m, l, acc):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != m.device:
            raise ValueError("flash_decode_combine: partials must be contiguous f32 on one device")
    if l.shape != m.shape or acc.shape != (b, h, lanes, ns, d):
        raise ValueError("flash_decode_combine: partial shapes disagree")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode_combine: output dtype {dtype} not supported")
    out = torch.empty((b, lanes, h, d), dtype=dtype, device=m.device)
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode_combine(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), b, lanes, h, d, ns,
        int(dtype == torch.bfloat16), torch.cuda.current_stream(m.device).cuda_stream,
    )
    _build.check(err, "flash_decode_combine")
    flash_decode_combine.launches += 1
    return out


def flash_decode(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal: bool = True, window: int = 0):
    """q: (B,L,H,D) decode lanes; k, v: (B,C,KV,D) paged cache -> (B,L,H,D).

    q_pos/q_seg: (B, L) int32 per-lane position / row-global segment (-1 =
    idle lane, gives exactly 0); k_pos/k_seg: (B, C) int32 per slot (-1 =
    empty).  All four are required.  On a CUDA tensor this runs the split
    and combine kernels or raises; on a CPU tensor it computes
    ``decode_attention_ref``."""
    if q_pos is None or k_pos is None or q_seg is None or k_seg is None:
        raise ValueError(
            "flash_decode: q_pos, k_pos, q_seg and k_seg are all required — "
            "cache slot order is arbitrary and cross-stream segment ordinals "
            "cannot be derived"
        )
    b, lanes, h, d = q.shape
    c, kvh = k.shape[1], k.shape[2]
    q_pos, q_seg = (as_rows(t, b, lanes, q.device) for t in (q_pos, q_seg))
    k_pos, k_seg = (as_rows(t, b, c, q.device) for t in (k_pos, k_seg))
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg,
                                    causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no implementation for device {q.device}")
    chunk, _ = split_plan(b, kvh, (h // kvh) * lanes, c, device_info(q.device.index)[1])
    m, l, acc = flash_decode_split(q, k, v, q_pos, k_pos, q_seg, k_seg,
                                   causal=causal, window=window, chunk=chunk)
    return flash_decode_combine(m, l, acc, q.dtype)


flash_decode_split.launches = 0
flash_decode_combine.launches = 0
