"""Decode attention over the paged KV cache: the one-launch CUDA kernel, its
wrapper and plain versions.

Counterpart of ``repro/kernels/flash_decode.py::flash_decode``, which on
the TPU runs the flash-attention kernel with Sq = L decode lanes against
Skv = C cache slots.  On Hopper it is one launch (``csrc/flash_decode.cu``):
the cache is cut into up to 8 chunks (the splits), the splits of one (batch
row, kv head, row group) are the blocks of one thread-block cluster, each
computes the (m, l, acc) partial of its chunk, and the cluster merges them
in distributed shared memory.  ``decode_split_ref`` and
``decode_combine_ref`` state that split arithmetic in plain PyTorch.
``with_lse=True`` also returns each lane's log-sum-exp (B, L, H) f32, the
merge's M + log(sum_s e^(m_s - M) l_s): K1's ``with_lse`` contract, so
that partial outputs over disjoint slot ranges (a cache split over the
model axis of a grid, sharding/placement.py::Placement.merge_partials)
merge into the whole cache's.

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

TILES = (64, 32)  # cache slots per kernel tile, in order of preference
ROWS_PER_BLOCK = 16  # query rows (G * L of one kv head) per block
MAX_SPLITS = 8  # blocks per cluster: the portable cluster size
DECODE_DIMS = (64, 128, 256)  # head dims the decode kernel is built for (256: bf16 only)
WIDE_D = 256  # built for 64-slot tiles only: a 32-slot ring cannot hold the warps' partials

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_decode": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _I, _I, _P],
    "flash_decode_active_clusters": [_I] * 10 + [ctypes.POINTER(_I)],
}


def decode_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal=True, window=0):
    """Plain paged-decode attention (port of ``ref.decode_attention_ref``):
    attention with every operand explicit; idle lanes and empty slots are
    masked and a lane with no reachable slot gives exactly 0."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window,
                             q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)[0]


def _chunks(tiles: int, want: int):
    """(tiles per chunk, splits) for ``tiles`` tiles: the fewest splits >=
    ``want`` that chunks of whole tiles give, else the most up to 8."""
    for n in range(want, MAX_SPLITS + 1):
        per = -(-tiles // n)
        splits = -(-tiles // per)  # <= n, and grows with n
        if splits >= want:
            break
    return per, splits


def split_plan(b: int, kvh: int, rows: int, c: int, n_sm: int, tiles=TILES):
    """The cluster plan (tile, chunk, splits): C slots cut into ``splits``
    <= 8 chunks of ``chunk`` slots, a whole number of tiles, so that the
    kernel's B * KV * row_groups * splits blocks cover the n_sm SMs at least
    twice.  A 64-slot tile is taken where that holds; otherwise the tile
    that gives more splits, which is then the most the tiles and a cluster
    allow (8, or one tile a split on a short cache)."""
    clusters = b * kvh * -(-rows // ROWS_PER_BLOCK)
    want = min(MAX_SPLITS, max(1, -(-2 * n_sm // clusters)))
    best = None
    for tile in tiles:
        per, splits = _chunks(-(-c // tile), want)
        plan = (tile, per * tile, splits)
        if clusters * splits >= 2 * n_sm:
            return plan
        if best is None or splits > best[2]:
            best = plan
    return best


def decode_split_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal, window, chunk):
    """The partials that the kernel's blocks compute, one per split: per
    chunk of ``chunk`` slots the running max m, denominator l (B,H,L,NS)
    and unnormalised accumulator acc (B,H,L,NS,D), all f32; a chunk with no
    valid slot has m = NEG_INF, l = 0, acc = 0."""
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


def decode_combine_ref(m, l, acc, dtype, with_lse: bool = False):
    """The merge that a cluster does in distributed shared memory: the
    (B,H,L,NS) partials into out (B,L,H,D) in ``dtype``; exactly 0 where
    every split has l == 0.  ``with_lse``: (out, lse (B,L,H) f32), lse =
    M + log(sum_s e^(m_s - M) l_s), NEG_INF where every split has l == 0."""
    mmax = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mmax)
    lsum = (w * l).sum(dim=-1)
    o = (w[..., None] * acc).sum(dim=-2)
    out = torch.where(lsum[..., None] > 0, o / lsum.clamp_min(1e-30)[..., None], 0.0)
    out = out.permute(0, 2, 1, 3).to(dtype)
    if not with_lse:
        return out
    lse = torch.where(lsum > 0, mmax[..., 0] + torch.log(lsum.clamp_min(1e-30)), NEG_INF)
    return out, lse.permute(0, 2, 1).contiguous()


def _plan(b, lanes, h, kvh, c, d, device):
    tiles = (64,) if d == WIDE_D else TILES
    return split_plan(b, kvh, (h // kvh) * lanes, c, device_info(device.index)[1], tiles)


def flash_decode(q, k, v, q_pos, k_pos, q_seg, k_seg, *, causal: bool = True, window: int = 0,
                 with_lse: bool = False):
    """q: (B,L,H,D) decode lanes; k, v: (B,C,KV,D) paged cache -> (B,L,H,D),
    or with ``with_lse`` (out, lse (B,L,H) f32; a lane that reaches no
    valid slot: out exactly 0, lse NEG_INF).

    q_pos/q_seg: (B, L) int32 per-lane position / row-global segment (-1 =
    idle lane, gives exactly 0); k_pos/k_seg: (B, C) int32 per slot (-1 =
    empty).  All four are required.  On a CUDA tensor this launches the
    kernel (one launch, clusters of ``split_plan`` blocks) or raises; on a
    CPU tensor it computes ``decode_attention_ref``, or with ``with_lse``
    the split arithmetic over the whole cache as one split
    (``decode_split_ref``, ``decode_combine_ref``)."""
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
        if with_lse:
            parts = decode_split_ref(q, k, v, q_pos, k_pos, q_seg, k_seg, causal=causal,
                                     window=window, chunk=c)
            return decode_combine_ref(*parts, q.dtype, with_lse=True)
        return decode_attention_ref(q, k, v, q_pos, k_pos, q_seg, k_seg,
                                    causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no implementation for device {q.device}")
    check_cuda_operands("flash_decode", q, k, v, (q_pos, k_pos, q_seg, k_seg), dims=DECODE_DIMS)
    if k.shape[0] != b:
        raise ValueError(f"flash_decode: q has {b} rows, the cache {k.shape[0]}")
    if d == WIDE_D and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_decode: head_dim {WIDE_D} is built for bf16, got {q.dtype}")
    tile, chunk, splits = _plan(b, lanes, h, kvh, c, d, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, lanes, h), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        q_seg.data_ptr(), k_seg.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, lanes, c, h, kvh, d,
        int(q.dtype == torch.bfloat16), int(causal), int(window), d**-0.5, tile, chunk, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return (out, lse) if with_lse else out


def active_clusters(q, k) -> int:
    """How many of ``flash_decode``'s clusters for these operands can be
    resident on the card at once (``cudaOccupancyMaxActiveClusters``)."""
    b, lanes, h, d = q.shape
    c, kvh = k.shape[1], k.shape[2]
    tile, chunk, splits = _plan(b, lanes, h, kvh, c, d, q.device)
    n = ctypes.c_int(0)
    lib = _build.library("flash_decode", _SIGNATURES)
    err = lib.flash_decode_active_clusters(b, lanes, c, h, kvh, d, int(q.dtype == torch.bfloat16),
                                           tile, chunk, splits, ctypes.byref(n))
    _build.check(err, "flash_decode_active_clusters")
    return n.value


flash_decode.launches = 0
