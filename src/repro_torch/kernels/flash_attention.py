"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (the TPU kernel
``_kernel`` behind ``_fwd_call`` / ``flash_attention``).  The kernel itself
is ``csrc/flash_attention.cu``; its source note gives the design and bound.

Positions and segments are explicit operands (the packed-sequence
contract): q_pos (B, Sq) / k_pos (B, Skv) int32 absolute positions, < 0 =
padding; q_seg / k_seg int32 segment ids, derived from positions by
``segment_ids_from_positions`` when not given.  Mask per (q, k) pair:
``q_pos >= 0 & k_pos >= 0 & q_seg == k_seg`` plus causal ``k_pos <= q_pos``
and window ``k_pos > q_pos - window``.  A query row with no valid key gives
exactly 0 and ``lse = NEG_INF``.

``flash_attention`` launches the kernel for a CUDA tensor (or raises) and
computes ``attention_fwd_ref`` for a CPU tensor; it is forward only.
``flash_attention_train`` is the differentiable form (``FlashAttentionFn``,
the counterpart of the reference's custom VJP ``_flash_fn``): its forward
is the kernel with the LSE, its backward the kernel of
``kernels/flash_attention_bwd.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend import HOPPER, device_info
from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P],
}


def segment_ids_from_positions(pos: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions -> (B, S) int32 segment ids: a new segment
    starts wherever the position does not increase by exactly 1."""
    pos = pos.to(torch.int32)
    starts = torch.cat(
        [torch.ones_like(pos[:, :1], dtype=torch.bool), pos[:, 1:] != pos[:, :-1] + 1], dim=1
    )
    return torch.cumsum(starts.to(torch.int32), dim=1, dtype=torch.int32) - 1


def resolve_positions(q_pos, k_pos, sq: int, skv: int, q_seg=None, k_seg=None, *, device=None):
    """Normalize the position operands: (q_pos, k_pos, q_seg, k_seg) int32.

    Both positions explicit -> segments derived unless also explicit;
    neither -> the implicit layout arange(S), defined only for Sq == Skv.
    Exactly one explicit position operand is an error.  Derived segment ids
    are per-stream ordinals: layouts where q and k are different streams
    with several segments must pass explicit segments.
    """
    if (q_pos is None) != (k_pos is None):
        raise ValueError(
            "flash_attention: q_pos and k_pos must be passed together "
            f"(got q_pos={'set' if q_pos is not None else None}, "
            f"k_pos={'set' if k_pos is not None else None})"
        )
    if q_pos is None:
        if sq != skv:
            raise ValueError(
                "flash_attention: implicit arange positions are only defined "
                f"for Sq == Skv, got Sq={sq}, Skv={skv}. "
                "Pass explicit q_pos/k_pos (B, S) int32 instead."
            )
        q_pos = k_pos = torch.arange(sq, dtype=torch.int32, device=device)[None, :]
        if q_seg is None:
            q_seg = torch.zeros((1, sq), dtype=torch.int32, device=device)
        if k_seg is None:
            k_seg = q_seg
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=device)
    k_pos = torch.as_tensor(k_pos, dtype=torch.int32, device=device)
    if q_seg is None:
        q_seg = segment_ids_from_positions(q_pos)
    if k_seg is None:
        k_seg = q_seg if k_pos is q_pos else segment_ids_from_positions(k_pos)
    q_seg = torch.as_tensor(q_seg, dtype=torch.int32, device=device)
    k_seg = torch.as_tensor(k_seg, dtype=torch.int32, device=device)
    return q_pos, k_pos, q_seg, k_seg


def attention_mask(q_pos, k_pos, q_seg=None, k_seg=None, *, causal: bool, window: int = 0):
    """(B | 1, Sq, Skv) validity mask from explicit (B, S) positions; segment
    ids are derived from the positions when not given (the contract of
    ``repro/kernels/ref.py::attention_mask``)."""
    q_pos = q_pos.to(torch.int32)
    k_pos = k_pos.to(torch.int32)
    if q_seg is None:
        q_seg = segment_ids_from_positions(q_pos)
    if k_seg is None:
        k_seg = segment_ids_from_positions(k_pos)
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    mask = (qp >= 0) & (kp >= 0) & (q_seg[:, :, None] == k_seg[:, None, :])
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def attention_fwd_ref(q, k, v, *, causal: bool, window: int = 0,
                      q_pos=None, k_pos=None, q_seg=None, k_seg=None):
    """Plain attention with the kernel's contract: (out (B,Sq,H,D) in q's
    dtype, lse (B,H,Sq) f32).  GQA maps head h to kv head h // (H/KV).  Port
    of ``repro/kernels/ref.py::attention_fwd_ref``; omitted positions are the
    implicit layout q_pos = arange(Sq), k_pos = arange(Skv), one segment."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if q_pos is None:
        q_pos = torch.arange(sq, dtype=torch.int32, device=q.device)[None]
        k_pos = torch.arange(skv, dtype=torch.int32, device=q.device)[None]
        q_seg = torch.zeros_like(q_pos)
        k_seg = torch.zeros_like(k_pos)
    qh = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) * d**-0.5
    mask = attention_mask(q_pos, k_pos, q_seg, k_seg, causal=causal, window=window)
    mask = mask[:, None, None]  # (B | 1, 1, 1, Sq, Skv)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    valid = l > 0.0
    out = torch.where(valid[..., None], acc / l.clamp_min(1e-30)[..., None], 0.0)
    lse = torch.where(valid, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def as_rows(t, b: int, s: int, device) -> torch.Tensor:
    """``t`` as a contiguous (B, S) int32 tensor on ``device``; no copy for a
    tensor that already is one (the decode path calls this every layer)."""
    t = torch.as_tensor(t, dtype=torch.int32, device=device)
    if t.shape != (b, s) or not t.is_contiguous():
        t = t.expand(b, s).contiguous()
    return t


def check_cuda_operands(name, q, k, v, ints, *, dims=HEAD_DIMS):
    """Raise unless (q, k, v, int operands) are what the kernel takes."""
    for t in (q, k, v, *ints):
        if t.device != q.device:
            raise ValueError(f"{name}: all operands must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    capability = device_info(q.device.index)[0]
    if capability != HOPPER:
        raise RuntimeError(
            f"{name}: the kernel is built for sm_90a (Hopper), got capability {capability}"
        )
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a dtype in {KERNEL_DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: positions and segments must be int32")
    d = q.shape[-1]
    if d not in dims or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: head_dim must be one of {dims} on q, k and v "
                         f"(q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)})")
    if q.shape[-2] % k.shape[-2]:
        raise ValueError(f"{name}: H={q.shape[-2]} is not a multiple of KV={k.shape[-2]}")


def _kernel(q, k, v, q_pos, k_pos, q_seg, k_seg, causal, window, with_lse):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    check_cuda_operands("flash_attention", q, k, v, (q_pos, k_pos, q_seg, k_seg))
    if k.shape[0] != b or q_pos.shape != (b, sq) or q_seg.shape != (b, sq) \
            or k_pos.shape != (b, skv) or k_seg.shape != (b, skv):
        raise ValueError("flash_attention: positions/segments must be (B, S) per side")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        q_seg.data_ptr(), k_seg.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        b, sq, skv, h, kvh, d, int(q.dtype == torch.bfloat16), int(causal), int(window),
        d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, q_pos=None, k_pos=None, q_seg=None, k_seg=None, *,
                    causal: bool = True, window: int = 0, with_lse: bool = False):
    """q: (B,Sq,H,D); k, v: (B,Skv,KV,D) -> out (B,Sq,H,D) [, lse (B,H,Sq) f32].

    Positions are explicit (B, S) int32 or both omitted (implicit arange,
    Sq == Skv).  On a CUDA tensor this launches the kernel (bf16 or f32,
    D in {64, 128}) or raises; on a CPU tensor it computes the plain
    ``attention_fwd_ref``.  Forward only."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    q_pos, k_pos, q_seg, k_seg = resolve_positions(
        q_pos, k_pos, sq, skv, q_seg, k_seg, device=q.device
    )
    q_pos, q_seg = (as_rows(t, b, sq, q.device) for t in (q_pos, q_seg))
    k_pos, k_seg = (as_rows(t, b, skv, q.device) for t in (k_pos, k_seg))
    if q.device.type == "cuda":
        out, lse = _kernel(q, k, v, q_pos, k_pos, q_seg, k_seg, causal, window, with_lse)
    elif q.device.type == "cpu":
        out, lse = attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     q_pos=q_pos, k_pos=k_pos, q_seg=q_seg, k_seg=k_seg)
    else:
        raise ValueError(f"flash_attention: no implementation for device {q.device}")
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def _fold(x, in_dim, size):
    """A vmapped operand with its batch dim moved to the front and folded
    into the leading (batch) axis; an unbatched one is expanded first."""
    x = x.expand(size, *x.shape) if in_dim is None else x.movedim(in_dim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x, size):
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the kernels in both directions, under autograd and
    ``torch.func`` alike.

    Forward: ``flash_attention(..., with_lse=True)``; it returns (out, lse)
    and lse takes no gradient.  Backward: ``delta = sum_d dO * O`` in f32
    (one plain reduction outside the kernel, as the reference computes it in
    jnp outside Pallas), then ``FlashAttentionBwdFn``; the position and
    segment operands get no gradient.  Under ``torch.func.vmap`` the vmapped
    dim folds into the batch axis, (k, B/k, S, H, D) -> (B, S, H, D), so k
    groups cost one forward launch, and the backward's own Function folds
    them into one backward launch: the kernels never see a batched tensor.
    First order only."""

    @staticmethod
    def forward(q, k, v, q_pos, k_pos, q_seg, k_seg, causal, window):
        return flash_attention(q, k, v, q_pos, k_pos, q_seg, k_seg, causal=causal,
                               window=window, with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, k_pos, q_seg, k_seg, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos, q_seg, k_seg)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, q_pos, k_pos, q_seg, k_seg = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq, dk, dv = FlashAttentionBwdFn.apply(q, k, v, lse, delta, do, q_pos, k_pos, q_seg,
                                               k_seg, ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, k_pos, q_seg, k_seg, causal, window):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in zip((q, k, v, q_pos, k_pos, q_seg, k_seg), in_dims)]
        out, lse = FlashAttentionFn.apply(*args, causal, window)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class FlashAttentionBwdFn(torch.autograd.Function):
    """The backward kernel as a Function of its own, so that its launch
    gets the same vmap rule as the forward's (a backward run under
    ``torch.func.vmap`` receives batched tensors).  Not differentiable."""

    @staticmethod
    def forward(q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg, causal, window):
        from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

        return flash_attention_bwd(q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg,
                                   causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the flash-attention backward is first order only")

    @staticmethod
    def vmap(info, in_dims, q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg, causal, window):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in
                zip((q, k, v, lse, delta, do, q_pos, k_pos, q_seg, k_seg), in_dims)]
        grads = FlashAttentionBwdFn.apply(*args, causal, window)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention_train(q, k, v, q_pos=None, k_pos=None, q_seg=None, k_seg=None, *,
                          causal: bool = True, window: int = 0):
    """Differentiable ``flash_attention``: (B,Sq,H,D) out, whose gradient
    runs the backward kernel (the plain versions on a CPU tensor)."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    q_pos, k_pos, q_seg, k_seg = resolve_positions(
        q_pos, k_pos, sq, skv, q_seg, k_seg, device=q.device
    )
    q_pos, q_seg = (as_rows(t, b, sq, q.device) for t in (q_pos, q_seg))
    k_pos, k_seg = (as_rows(t, b, skv, q.device) for t in (k_pos, k_seg))
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                  q_pos, k_pos, q_seg, k_seg, causal, window)[0]
