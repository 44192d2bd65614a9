"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]).

Port of ``repro/models/recurrent.py``.

Block:  x -> { gate branch: W_y -> GeLU }  ⊙  { rec branch: W_gatein ->
causal depthwise conv1d(4) -> RG-LRU }  -> W_out.

RG-LRU:  r_t = σ(W_a ξ_t),  i_t = σ(W_x ξ_t),
         log a_t = -c · softplus(Λ) · r_t          (c = 8)
         h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ ξ_t)

Training and prefill run the linear recurrence as a log-depth doubling scan
over the sequence (the reference's ``jax.lax.associative_scan`` with the
same combine ``(a1 a2, a2 b1 + b2)``): ceil(log2 S) element-wise passes.
Decode carries (h, conv window) in a constant-size cache
``{"h": (B, D) f32, "conv": (B, 3, D)}``.  ``a_log`` is kept and used in f32.

On a GridMesh (``tp``) the model axis splits the channels: the
recurrence is diagonal, so each rank scans its own D/M of them.  The gate
branch and r, i are column products into the rank's channels, ``a_log``
is read at them, ξ (the input projection and the conv) is computed whole
on every model rank and entered once, and ``w_out`` is the row product
summed over the model axis.  Serving there holds the reference's cache
rule's blocks: ``h`` the rank's channels (B, D/M), ``conv`` whole over the
model axis (B, 3, D), as ξ is computed whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init

RG_C = 8.0
CONV_W = 4


def rglru_init(gen, d_model: int, device="cpu") -> Dict:
    d = d_model  # rnn width == d_model
    lin = torch.linspace(0.9, 0.999, d, dtype=torch.float32, device=device)
    return {
        "w_y": normal_init(gen, (d_model, d), device=device),
        "w_gatein": normal_init(gen, (d_model, d), device=device),
        "w_rg_a": normal_init(gen, (d, d), device=device),
        "w_rg_x": normal_init(gen, (d, d), device=device),
        "a_log": torch.log(torch.expm1(lin ** (1.0 / RG_C))),  # softplus^-1
        "conv_w": normal_init(gen, (CONV_W, d), fan_in=CONV_W, device=device),
        "w_out": normal_init(gen, (d, d_model), device=device),
    }


def causal_conv(w: torch.Tensor, x: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width CONV_W.  x (B, S, D), state (B, 3, D)
    (None: zeros) -> (out (B, S, D), the new state: the last 3 inputs)."""
    b, s, d = x.shape
    if state is None:
        state = x.new_zeros((b, CONV_W - 1, d))
    xp = torch.cat([state, x], dim=1)
    out = sum(w[i].to(x.dtype) * xp[:, i:i + s] for i in range(CONV_W))
    return out, xp[:, -(CONV_W - 1):]


def linear_scan(a: torch.Tensor, bx: torch.Tensor, h0: Optional[torch.Tensor]):
    """h_t = a_t h_{t-1} + bx_t over axis 1 (h_{-1} = h0, or 0) by doubling:
    after the pass of offset o, element t holds the combine of the inputs
    (t - 2o, t], so ceil(log2 S) passes cover the prefix."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev = torch.cat([torch.ones_like(a[:, :off]), a[:, :-off]], dim=1)
        b_prev = torch.cat([torch.zeros_like(bx[:, :off]), bx[:, :-off]], dim=1)
        bx = a * b_prev + bx
        a = a * a_prev
        off *= 2
    return bx


def apply_rglru(p: Dict, x: torch.Tensor, cache: Optional[Dict] = None,
                mode: str = "train", tp=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d_model) -> (out, cache').  Prefill and decode return the
    cache {"h": (B, D) f32, "conv": (B, 3, D)}; train returns None.
    ``tp``: a sharding/placement.py::Placement whose model axis splits the
    channels (module note): w_y, w_rg_a and w_rg_x are then the rank's
    columns, a_log and w_out whole, and a cache's ``h`` the rank's
    channels."""
    dtype = x.dtype
    xi = x @ p["w_gatein"].to(dtype)
    xi, new_conv = causal_conv(p["conv_w"], xi, None if cache is None else cache["conv"])
    if tp is not None:
        proj = lambda v, w: tp.col_product(v, w, dtype)
        x, xi_all = tp.enter(x), tp.enter(xi)
        xi_own, a_log = tp.own(xi_all), tp.own(p["a_log"])
    else:
        proj = lambda v, w: v @ w.to(dtype)
        xi_all, xi_own, a_log = xi, xi.float(), p["a_log"]
    gate = F.gelu(proj(x, p["w_y"]), approximate="tanh")
    r = torch.sigmoid(proj(xi_all, p["w_rg_a"]).float())
    i = torch.sigmoid(proj(xi_all, p["w_rg_x"]).float())
    log_a = -RG_C * F.softplus(a_log.float()) * r  # (B, S, D) f32
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xi_own)

    h0 = None if cache is None else cache["h"]
    if mode == "decode":  # a few steps (typically one): the plain recurrence
        h_t = torch.zeros_like(bx[:, 0]) if h0 is None else h0
        hs = []
        for t in range(bx.shape[1]):
            h_t = a[:, t] * h_t + bx[:, t]
            hs.append(h_t)
        h = torch.stack(hs, dim=1)
    else:
        h = linear_scan(a, bx, h0)
    hg = h.to(dtype) * gate
    out = hg @ p["w_out"].to(dtype) if tp is None else tp.row_product(hg, p["w_out"])
    new_cache = {"h": h[:, -1], "conv": new_conv} if mode in ("prefill", "decode") else None
    return out, new_cache


def rglru_cache(batch: int, d_model: int, dtype, device) -> Dict:
    """The decode cache's tensors, zero (``device="meta"``: shapes only)."""
    return {"h": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, d_model), dtype=dtype, device=device)}
