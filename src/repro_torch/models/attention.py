"""Attention layer: GQA/MQA, causal, sliding-window, paged KV cache, and
cross-attention to an encoder's or an image's memory.

Port of ``repro/models/attention.py``.  Three execution paths, one masking
contract:

  * naive      — ``_sdpa``: materialize the (Sq, Skv) scores;
  * chunked    — ``_chunked_sdpa``: online softmax over q and kv chunks, for
                 long sequences;
  * fused      — the hand-written CUDA kernels through ``kernels/ops.py``:
                 flash-attention forward for train/prefill (differentiable
                 in train mode: its backward is the backward kernel) and
                 split-KV flash decode over the paged cache.  Selected by the plan's
                 ``attention`` subsystem (repro_torch.backend.Backend).

Positions < 0 are padding, causal/window compare absolute positions, and
segment ids (derived from positions by ``segment_ids_from_positions`` or
passed explicitly) gate cross-document attention in packed rows.

KV caches are PAGED and segment-aware, as in the reference: a token's slot
is its arrival index (the row's ``fill`` cursor plus its rank among this
call's valid tokens) mod cache_len, and every slot stores its position
(``kpos``, -1 = empty) and row-global segment id (``kseg``).  Unlike the
reference, which returns new arrays, the port writes the cache IN PLACE:
the returned dict holds the same tensors, and a cache passed to a decode
step is consumed by it (the reference's engines donate it the same way).

On a GridMesh (``grid``: a sharding/placement.py::Placement) prefill and
decode serve from a cache placed by the reference's cache rule: each rank
holds its data rows' cache for a contiguous block of the slots (``slots``:
the block's first slot and the whole ring's count), every kv head.  The
ring's arrival order, ``fill`` and the pads' spare slot are the whole
ring's; a rank writes only the tokens whose slot lies in its block.
Prefill runs the forward kernel within the fresh sequence on the rank's
heads (``tp``) or all of them, then gathers the fresh k and v of every kv
head over the model axis for the write.  Decode gathers q of every head,
runs the decode kernel with its log-sum-exp over the rank's slots and
merges the model ranks' partial outputs by their log-sum-exps
(``Placement.merge_partials``) before the output projection (the row
product over the rank's heads under ``tp``).

Cross-attention (``memory`` given) projects the memory to k, v at train
and prefill time (prefill keeps them as the cross cache {"k", "v",
"kpos"}, which decode reads); it has no causal mask, window or segments.
Train and prefill run the fused kernels with Sq != Skv and explicit
all-zero segments on both sides, so only position validity masks; cross
decode runs the plain ``_sdpa`` over the cross cache, as the reference
runs its jnp path there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.backend import Backend
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import segment_ids_from_positions
from repro_torch.models.common import apply_rope, normal_init

NEG_INF = -1e30


def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              device="cpu") -> Dict:
    return {
        "wq": normal_init(gen, (d_model, n_heads * head_dim), device=device),
        "wk": normal_init(gen, (d_model, n_kv_heads * head_dim), device=device),
        "wv": normal_init(gen, (d_model, n_kv_heads * head_dim), device=device),
        "wo": normal_init(gen, (n_heads * head_dim, d_model), fan_in=n_heads * head_dim,
                          device=device),
    }


def _mask(q_pos, k_pos, causal: bool, window: int, q_seg=None, k_seg=None):
    """q_pos (B, Sq), k_pos (B, Skv), optional segment ids of the same shapes
    (None = no segment gating) -> bool (B, Sq, Skv)."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = (kp >= 0) & (qp >= 0)
    if q_seg is not None:
        m &= q_seg[:, :, None] == k_seg[:, None, :]
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    return m


def _sdpa(q, k, v, mask, with_lse: bool = False):
    """q: (B,Sq,K,G,D); k,v: (B,Skv,K,D); mask: (B,Sq,Skv) -> (B,Sq,K,G,D).
    Rows with no valid key give exactly 0.  ``with_lse``: also the rows'
    log-sum-exp (B,Sq,K*G) f32, NEG_INF where no key is valid (the decode
    kernel's ``with_lse``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    live = mask.any(-1)[:, None, None, :]
    w = torch.where(live[..., None], w, 0)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    if not with_lse:
        return out
    lse = torch.where(live, torch.logsumexp(scores, dim=-1), NEG_INF)  # (B,K,G,Sq)
    b, kh, g, sq = lse.shape
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, kh * g)


def _chunked_sdpa(q, k, v, q_pos, k_pos, causal, window, q_chunk, kv_chunk,
                  q_seg=None, k_seg=None):
    """Online-softmax attention; same result as ``_sdpa`` in O(chunk^2)
    memory.  The reference's scans over q and kv chunks become loops; its
    padding of the last chunk (masked entries) becomes a shorter slice."""
    b, sq, kh, g, d = q.shape
    skv = k.shape[1]
    if q_seg is None:  # all-zero segments == no segment gating
        q_seg = torch.zeros_like(q_pos)
        k_seg = torch.zeros_like(k_pos)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    scale = d**-0.5
    outs = []
    for q0 in range(0, sq, q_chunk):
        qb = q[:, q0:q0 + q_chunk]
        qp, qg = q_pos[:, q0:q0 + q_chunk], q_seg[:, q0:q0 + q_chunk]
        cq = qb.shape[1]
        m_run = torch.full((b, kh, g, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, kh, g, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, cq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, kv_chunk):
            kb, vb = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kp, kg = k_pos[:, k0:k0 + kv_chunk], k_seg[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).float() * scale
            msk = _mask(qp, kp, causal, window, qg, kg)[:, None, None, :, :]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            # exact zeros off-mask (a fully masked chunk has s == m == NEG_INF)
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb
            ).float()
            m_run = m_new
        out = torch.where(l_run[..., None] > 0, acc / l_run.clamp_min(1e-30)[..., None], 0.0)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,Cq,K,G,D)
    return torch.cat(outs, dim=1).to(v.dtype)


def _paged_write(cache: Dict, k_in, v_in, pos_in, seg_in, slots=None) -> None:
    """Scatter this call's valid tokens (pos >= 0) into the paged cache in
    arrival order and advance ``fill``; pads neither write nor advance.

    Pads are routed to a spare slot, (fill + n_valid) % C, which no valid
    token of this call writes, and rewrite it with its own contents — the
    reference's out-of-bounds drop, without a data-dependent shape (and so
    without a host sync on the card).

    ``slots`` = (lo, C): the cache is the block [lo, lo + c) of a ring of C
    slots (a grid's model rank).  Arrival, ``fill`` and the spare slot are
    the ring's; a token whose slot lies outside the block (and every pad)
    goes to one slot of the block, d (the spare's place, else the first),
    and writes there what d ends with: the block's own token for d, if one
    comes, else d's contents."""
    ck, cv, ckpos, ckseg, cfill = (cache[n] for n in ("k", "v", "kpos", "kseg", "fill"))
    c = ck.shape[1]
    lo, ring = (0, c) if slots is None else slots
    valid = pos_in >= 0
    arrival = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    spare = (cfill + n_valid) % ring
    slot = torch.where(valid, (cfill[:, None] + arrival) % ring, spare[:, None]).long()
    new = (k_in, v_in, pos_in, seg_in)
    old = (ck, cv, ckpos, ckseg)
    if slots is None:
        own = valid
        keep = tuple(t.gather(1, slot.view(*slot.shape, *(1,) * (t.ndim - 2)).expand_as(n))
                     for t, n in zip(old, new))
    else:
        slot = slot - lo
        own = valid & (slot >= 0) & (slot < c)
        d = spare.long() - lo
        d = torch.where((d >= 0) & (d < c), d, 0)
        slot = torch.where(own, slot, d[:, None])
        writes_d = own & (slot == d[:, None])  # at most one token of a row
        rows = torch.arange(slot.shape[0], device=slot.device)
        src = writes_d.to(torch.int32).argmax(dim=1)
        has = writes_d.any(dim=1)

        def at_d(n, t):
            x = torch.where(has.view(-1, *(1,) * (n.ndim - 2)), n[rows, src], t[rows, d])
            return x[:, None].expand_as(n)

        keep = tuple(at_d(n, t) for n, t in zip(new, old))
    k_w, v_w, pos_w, seg_w = (
        torch.where(own.view(*own.shape, *(1,) * (n.ndim - 2)), n, kp) for n, kp in zip(new, keep))
    idx4 = slot[..., None, None].expand_as(k_in)
    ck.scatter_(1, idx4, k_w)
    cv.scatter_(1, idx4, v_w)
    ckpos.scatter_(1, slot, pos_w)
    ckseg.scatter_(1, slot, seg_w)
    cfill.add_(n_valid)


def empty_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int, dtype, device):
    """A paged cache with every slot empty (kpos/kseg -1, fill 0)."""
    return {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "kpos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
        "kseg": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
        "fill": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def attention(
    p: Dict,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    q_pos: torch.Tensor,
    rope_theta: float = 0.0,
    causal: bool = True,
    window: int = 0,
    memory: Optional[torch.Tensor] = None,
    mem_pos: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    mode: str = "train",
    attn_chunk: int = 1024,
    cache_len: int = 0,
    backend: Optional[Backend] = None,
    implicit_layout: bool = False,
    q_seg: Optional[torch.Tensor] = None,
    seg_base: Optional[torch.Tensor] = None,
    tp=None,
    grid=None,
    slots: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention.

    memory: (B, M, d) for cross-attention (causal and window are ignored);
    mem_pos: (B, M) its positions (None: arange(M)).
    mode: "train" (no cache), "prefill" (builds a fresh cache, or appends
    into ``cache`` when given; attends within the fresh sequence), "decode"
    (x is (B, L, d): L lanes decode in lock-step against the cache).
    q_pos: (B, S) int32 absolute positions, < 0 = padding.  q_seg: (B, S)
    explicit segment ids, None derives them from q_pos; decode needs them
    explicit when a row holds more than one document.  seg_base: (B,)
    offset added to the segment ids (a prefill chunk continuing a cache
    row's numbering).  implicit_layout: q_pos is the broadcast arange(S),
    whose segments are all zero.  Returns (out (B,S,d), cache or None).
    tp: a sharding/placement.py::Placement whose model axis splits the heads
    (self- or cross-attention): ``n_heads`` / ``n_kv_heads`` are then
    the rank's, ``p``'s wq/wk/wv its columns and wo whole; the projections
    take the entered input (and memory: ``tp.col_product``) and the output
    is the row product summed over the model axis (``tp.row_product``).
    grid: the rank's Placement in prefill and decode on a GridMesh (self-
    attention; module note), whatever ``tp`` says of the heads; ``slots``
    (first slot, the ring's slot count) of the rank's block of the cache,
    None when the cache's slots are whole on the rank.
    """
    plan = backend if backend is not None else Backend()
    b, s, _ = x.shape
    dtype = x.dtype
    if memory is not None and (grid is not None or (tp is not None and mode != "train")):
        raise NotImplementedError(f"cross-attention in {mode} mode on a grid (its cache's "
                                  "merge needs the plain cross path's LSE: ROADMAP A9.4b)")
    if memory is not None:
        return _cross_attention(p, x, memory, mem_pos, n_heads=n_heads, n_kv_heads=n_kv_heads,
                                head_dim=head_dim, q_pos=q_pos, cache=cache, mode=mode,
                                attn_chunk=attn_chunk, plan=plan, tp=tp)

    if q_seg is not None:
        seg_q = q_seg.to(torch.int32)
    elif implicit_layout:
        seg_q = None
    else:
        seg_q = segment_ids_from_positions(q_pos)
    if seg_q is not None and seg_base is not None:
        seg_q = seg_q + seg_base.to(torch.int32)[:, None]

    if tp is not None:
        xe = tp.enter(x)
        proj = lambda w: tp.col_product(xe, w, dtype)
    else:
        proj = lambda w: x @ w.to(dtype)
    q = proj(p["wq"]).reshape(b, s, n_heads, head_dim)
    k = proj(p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = proj(p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if rope_theta:
        q = apply_rope(q, q_pos, rope_theta)
        k = apply_rope(k, q_pos, rope_theta)
    if mode == "train":
        k_pos = q_pos
        new_cache = None
    else:
        # the cache holds every kv head (of its block of the slots, on a grid)
        k_all, v_all = k, v
        if tp is not None and mode == "decode":
            q, k_all, v_all = tp.gather_heads(q, k, v)
        elif tp is not None:
            k_all, v_all = tp.gather_heads(k, v)
        if mode == "prefill" and cache is None:
            c_block = cache_len if slots is None else cache_len // grid.m
            cache = empty_cache(b, c_block, k_all.shape[2], head_dim, dtype, x.device)
        c = cache["k"].shape[1] if slots is None else slots[1]
        seg_in = seg_q if seg_q is not None else torch.zeros_like(q_pos)
        # only the last <= c tokens of an over-long prefill survive the ring
        if mode == "prefill" and s > c:
            k_in, v_in, pos_in, seg_w = (t[:, -c:] for t in (k_all, v_all, q_pos, seg_in))
        else:
            k_in, v_in, pos_in, seg_w = k_all, v_all, q_pos, seg_in
        _paged_write(cache, k_in, v_in, pos_in, seg_w, slots)
        new_cache = dict(cache)
        if mode == "decode":
            k, v, k_pos = cache["k"], cache["v"], cache["kpos"]
        else:
            k_pos = q_pos  # prefill attends within the fresh sequence
    heads, kv_heads = q.shape[2], k.shape[2]
    g = heads // kv_heads

    qh = q.reshape(b, s, kv_heads, g, head_dim)
    naive_elems = s * k.shape[1]
    if mode == "decode":
        if seg_q is None:  # implicit-layout decode: single segment 0
            seg_q = torch.zeros_like(q_pos)
        seg_k = new_cache["kseg"]
    else:
        seg_k = seg_q
    fused = plan.fused("attention", x.device)
    if fused and mode in ("train", "prefill"):
        train = mode == "train"  # differentiable: the backward runs its kernel too
        if implicit_layout:
            out = kops.flash_attention(qh, k, v, causal=causal, window=window, train=train)
        else:
            out = kops.flash_attention(qh, k, v, q_pos, k_pos, q_seg=seg_q, k_seg=seg_k,
                                       causal=causal, window=window, train=train)
    elif fused and mode == "decode" and slots is not None:
        out, lse = kops.flash_decode(qh, k, v, q_pos, k_pos, seg_q, seg_k, causal=causal,
                                     window=window, with_lse=True)
    elif fused and mode == "decode":
        out = kops.flash_decode(qh, k, v, q_pos, k_pos, seg_q, seg_k,
                                causal=causal, window=window)
    elif mode == "decode" and slots is not None:
        out, lse = _sdpa(qh, k, v, _mask(q_pos, k_pos, causal, window, seg_q, seg_k),
                         with_lse=True)
    elif attn_chunk and naive_elems > attn_chunk * attn_chunk * 4:
        out = _chunked_sdpa(qh, k, v, q_pos, k_pos, causal, window, attn_chunk, attn_chunk,
                            q_seg=seg_q, k_seg=seg_k)
    else:
        out = _sdpa(qh, k, v, _mask(q_pos, k_pos, causal, window, seg_q, seg_k))
    if mode == "decode" and slots is not None:  # the model ranks' blocks of the slots
        out = grid.merge_partials(out.reshape(b, s, heads, head_dim), lse)
    if mode == "decode" and tp is not None:  # the rank's heads of every head's output
        out = tp.own(out.reshape(b, s, heads, head_dim), 2)
    out = out.reshape(b, s, n_heads * head_dim)
    if tp is not None:
        return tp.row_product(out, p["wo"]), new_cache
    return out @ p["wo"].to(dtype), new_cache


def _cross_attention(p: Dict, x, memory, mem_pos, *, n_heads, n_kv_heads, head_dim, q_pos,
                     cache, mode, attn_chunk, plan: Backend, tp=None):
    """``tp`` (train): q from the entered x, k and v from the entered memory
    (so the memory's gradient is summed over the model axis), each into the
    rank's heads; the output is the row product."""
    b, s, _ = x.shape
    g = n_heads // n_kv_heads
    dtype = x.dtype
    if tp is not None:
        proj = lambda t, w: tp.col_product(t, w, dtype)
        x = tp.enter(x)
    else:
        proj = lambda t, w: t.to(dtype) @ w.to(dtype)
    q = proj(x, p["wq"]).reshape(b, s, n_kv_heads, g, head_dim)
    if mode == "decode" and cache is not None:
        k, v, k_pos = cache["k"], cache["v"], cache["kpos"]
        new_cache = cache
    else:
        src = memory.to(dtype) if tp is None else tp.enter(memory.to(dtype))
        m = src.shape[1]
        k = proj(src, p["wk"]).reshape(b, m, n_kv_heads, head_dim)
        v = proj(src, p["wv"]).reshape(b, m, n_kv_heads, head_dim)
        if mem_pos is None:
            k_pos = torch.arange(m, dtype=torch.int32, device=x.device)[None, :].expand(b, m)
        else:
            k_pos = mem_pos.to(torch.int32)
        new_cache = {"k": k, "v": v, "kpos": k_pos} if mode == "prefill" else None
    q_pos = q_pos.to(torch.int32)
    if plan.fused("attention", x.device) and mode in ("train", "prefill"):
        out = kops.flash_attention(q, k, v, q_pos, k_pos, q_seg=torch.zeros_like(q_pos),
                                   k_seg=torch.zeros_like(k_pos), causal=False, window=0,
                                   train=mode == "train")
    elif attn_chunk and s * k.shape[1] > attn_chunk * attn_chunk * 4:
        out = _chunked_sdpa(q, k, v, q_pos, k_pos, False, 0, attn_chunk, attn_chunk)
    else:
        out = _sdpa(q, k, v, _mask(q_pos, k_pos, False, 0))
    out = out.reshape(b, s, n_heads * head_dim)
    if tp is not None:
        return tp.row_product(out, p["wo"]), new_cache
    return out @ p["wo"].to(dtype), new_cache
