"""Shared model primitives: initializers, norms, RoPE, embeddings, head.

Port of ``repro/models/common.py``.  Parameters are nested dicts of tensors
with the reference's leaf names (wq wk wv wo, wi wg wd, embed head, scale
bias; the MoE, RG-LRU and xLSTM leaves in their modules) and its
``(in, out)`` weight layout, so ``x @ W`` needs no transpose.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def normal_init(gen: torch.Generator, shape, fan_in=None, dtype=torch.float32, device="cpu"):
    """N(0, 1/fan_in) weights (fan_in defaults to shape[-2]), the reference's
    init distribution; the draws come from ``gen`` and differ from JAX's."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(1, fan_in))
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def norm_init(d: int, kind: str, device="cpu") -> Dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, device=device)}
    return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def apply_norm(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm in f32 (scale applied in f32), cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Head-wise group norm of the xLSTM cells: x (..., H, D) normalized over
    D in f32, no affine, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Split-halves rotation (not
    interleaved), computed in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embedding_init(gen, vocab: int, d: int, device="cpu") -> Dict:
    return {"embed": normal_init(gen, (vocab, d), fan_in=d, device=device)}


def embed_tokens(p: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Cast the table to ``dtype``, then gather (a no-op cast when the table
    already is a compute-dtype copy)."""
    return p["embed"].to(dtype)[tokens]


def head_init(gen, d: int, vocab: int, device="cpu") -> Dict:
    return {"head": normal_init(gen, (d, vocab), fan_in=d, device=device)}


def apply_head(p: Dict, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """f32 logits x @ head, optionally soft-capped: tanh(l / c) * c."""
    logits = x.float() @ p["head"].float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
