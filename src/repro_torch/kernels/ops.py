"""Model-facing adapters of the attention kernels (the counterpart of the
attention entries of ``repro/kernels/ops.py``): they reshape the model's
grouped query layout (B, S, KV, G, D) to the kernels' (B, S, H, D) and back.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd


def flash_attention(qh, k, v, q_pos=None, k_pos=None, *, q_seg=None, k_seg=None,
                    causal: bool = True, window: int = 0):
    """qh (B,S,KV,G,D) against k, v (B,Skv,KV,D) -> (B,S,KV,G,D).  Omitted
    positions mean the implicit arange layout; segments are derived from the
    positions when not supplied."""
    b, s, kvh, g, d = qh.shape
    out = fa.flash_attention(qh.reshape(b, s, kvh * g, d), k, v, q_pos, k_pos, q_seg, k_seg,
                             causal=causal, window=window)
    return out.reshape(b, s, kvh, g, d)


def flash_decode(qh, k, v, q_pos, k_pos, q_seg, k_seg, *, causal: bool = True, window: int = 0):
    """qh (B,L,KV,G,D) lanes against a paged (B,C,KV,D) cache ->
    (B,L,KV,G,D).  All four position/segment operands are required."""
    b, l, kvh, g, d = qh.shape
    out = fd.flash_decode(qh.reshape(b, l, kvh * g, d), k, v, q_pos, k_pos, q_seg, k_seg,
                          causal=causal, window=window)
    return out.reshape(b, l, kvh, g, d)
