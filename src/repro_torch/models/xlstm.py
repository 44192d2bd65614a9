"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) and sLSTM (scalar).

Port of ``repro/models/xlstm.py``.

mLSTM cell (per head, exponential input gate, stabilizer m):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    i'  = exp(ĩ_t - m_t)        f' = exp(f̃_t + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' k_t v_tᵀ          n_t = f' n_{t-1} + i' k_t
    h_t = (C_tᵀ q_t) / max(|n_t · q_t|, exp(-m_t))

Training and prefill use the chunkwise-parallel form (intra-chunk products
like attention's, the recurrence only across chunk boundaries; a Python
loop over the chunks); ``mlstm_sequential`` is the decode path and the
oracle.  The sLSTM keeps the paper's sequential scan (its per-head
recurrent weights ``sl_r``, in f32, make it non-associative): a Python loop
over the sequence, as the reference's ``lax.scan`` is.

States are tuples as in the reference: mLSTM (C (B,H,Dk,Dv), n (B,H,Dk),
m (B,H)), sLSTM (c, n, m, h), each (B, d), all f32.

Block wiring (pre-norm residual; d_ff == 0, the blocks carry their own
projections):
  mLSTM block:  up-proj (2x) -> [conv+silu -> q,k; v from the unconvolved
                branch; gates from the conv'd branch] -> cell -> head group
                norm -> ⊙ silu(z) -> down-proj (``xl_down``)
  sLSTM block:  conv+silu -> i,f,z,o preacts (+ block-diagonal recurrence
                R h) -> cell -> group norm -> gated FFN (4/3) -> down-proj
                (``sl_down``)
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import group_norm, normal_init
from repro_torch.models.recurrent import CONV_W, causal_conv

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen, d_model: int, n_heads: int, qk_factor: float = 0.5, device="cpu") -> Dict:
    di = 2 * d_model  # projection factor 2
    dqk = int(di * qk_factor)
    return {
        "xl_up": normal_init(gen, (d_model, 2 * di), device=device),
        "xl_conv": normal_init(gen, (CONV_W, di), fan_in=CONV_W, device=device),
        "xl_q": normal_init(gen, (di, dqk), device=device),
        "xl_k": normal_init(gen, (di, dqk), device=device),
        "xl_v": normal_init(gen, (di, di), device=device),
        "xl_if": normal_init(gen, (di, 2 * n_heads), device=device),
        "xl_if_b": torch.cat([torch.zeros(n_heads, device=device),  # forget-gate bias init
                              torch.linspace(3.0, 6.0, n_heads, device=device)]),
        "xl_down": normal_init(gen, (di, d_model), fan_in=di, device=device),
    }


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _zero_state(b, hh, dk, dv, device):
    return (torch.zeros((b, hh, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, hh, dk), dtype=torch.float32, device=device),
            torch.full((b, hh), NEG, dtype=torch.float32, device=device))


def mlstm_sequential(q, k, v, ig, fg, state=None):
    """Decode path / oracle.  q, k (B,S,H,Dk); v (B,S,H,Dv); ig, fg (B,S,H);
    state (C, n, m) or None -> (h (B,S,H,Dv) f32, final state)."""
    b, s, hh, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    C, n, m = _zero_state(b, hh, dk, dv, q.device) if state is None else state
    hs = []
    for t in range(s):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, ft = ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        qs = qt * scale
        num = torch.einsum("bhk,bhkv->bhv", qs, C)
        den = torch.abs(torch.einsum("bhk,bhk->bh", qs, n))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunkwise(q, k, v, ig, fg, state=None, chunk: int = 64):
    """Chunkwise-parallel mLSTM, equal to ``mlstm_sequential`` up to
    rounding.  The tail is padded to a whole chunk with ig = -1e30 (its
    input weight exp(ig - m) is 0) and fg = 0 (no decay)."""
    b, s, hh, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    C, n, m_prev = _zero_state(b, hh, dk, dv, q.device) if state is None else state
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        zf = lambda a: F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        q, k, v = zf(q), zf(k), zf(v)
        ig = F.pad(ig, (0, 0, 0, pad), value=NEG)
        fg = F.pad(fg, (0, 0, 0, pad))
    nc = q.shape[1] // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        icf, fcf = ig[:, sl].float(), fg[:, sl].float()
        qf = q[:, sl].float() * scale
        kf, vf = k[:, sl].float(), v[:, sl].float()
        g = torch.cumsum(fcf, dim=1)  # (B,L,H) inclusive log-decay
        # intra-chunk log weights: w[t,s] = g_t - g_s + i_s  (s <= t)
        lw = g[:, :, None, :] - g[:, None, :, :] + icf[:, None, :, :]  # (B,T,S,H)
        lw = torch.where(tri[None, :, :, None], lw, NEG)
        m_intra = lw.amax(dim=2)  # (B,T,H)
        m_inter = g + m_prev[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        wts = torch.exp(lw - m_t[:, :, None, :])
        qk = torch.einsum("bthd,bshd->btsh", qf, kf) * wts
        num_intra = torch.einsum("btsh,bshv->bthv", qk, vf)
        den_intra = qk.sum(dim=2)
        dec = torch.exp(m_inter - m_t)
        num_inter = torch.einsum("bthk,bhkv->bthv", qf, C) * dec[..., None]
        den_inter = torch.einsum("bthk,bhk->bth", qf, n) * dec
        den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_t))
        hs.append((num_intra + num_inter) / den[..., None])
        # the state at the end of the chunk
        g_last = g[:, -1]  # (B,H)
        m_new = torch.maximum(g_last + m_prev, (g_last[:, None] - g + icf).amax(dim=1))
        sw = torch.exp(g_last[:, None] - g + icf - m_new[:, None])  # (B,S,H)
        carry = torch.exp(g_last + m_prev - m_new)
        C = carry[..., None, None] * C + torch.einsum("bsh,bshk,bshv->bhkv", sw, kf, vf)
        n = carry[..., None] * n + torch.einsum("bsh,bshk->bhk", sw, kf)
        m_prev = m_new
    h = torch.cat(hs, dim=1)[:, :s]
    return h, (C, n, m_prev)


def apply_mlstm(p: Dict, x: torch.Tensor, n_heads: int, cache: Optional[Dict] = None,
                mode: str = "train", chunk: int = 64):
    """(x_res, hidden, cache): the block's output (before the residual add)
    is ``hidden @ xl_down``."""
    dtype = x.dtype
    b, s, _ = x.shape
    up = x @ p["xl_up"].to(dtype)
    xm, z = torch.chunk(up, 2, dim=-1)
    xc, new_conv = causal_conv(p["xl_conv"], xm, None if cache is None else cache["conv"])
    xc = F.silu(xc)
    q = _heads(xc @ p["xl_q"].to(dtype), n_heads)
    k = _heads(xc @ p["xl_k"].to(dtype), n_heads)
    v = _heads(xm @ p["xl_v"].to(dtype), n_heads)
    gates = (xc @ p["xl_if"].to(dtype)).float() + p["xl_if_b"].float()
    ig, fgp = torch.chunk(gates, 2, dim=-1)  # (B,S,H)
    fg = F.logsigmoid(fgp)
    state = None if cache is None else cache["state"]
    if mode == "decode" or s == 1:
        h, new_state = mlstm_sequential(q, k, v, ig, fg, state)
    else:
        h, new_state = mlstm_chunkwise(q, k, v, ig, fg, state, chunk=chunk)
    h = group_norm(h).to(dtype).reshape(b, s, -1)
    hidden = h * F.silu(z)
    new_cache = {"conv": new_conv, "state": new_state} if mode in ("prefill", "decode") else None
    return hidden, new_cache


def mlstm_cache(batch: int, d_model: int, n_heads: int, qk_factor: float, dtype, device) -> Dict:
    di = 2 * d_model
    dk, dv = int(di * qk_factor) // n_heads, di // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, CONV_W - 1, di), dtype=dtype, device=device),
            "state": (torch.zeros((batch, n_heads, dk, dv), **f32),
                      torch.zeros((batch, n_heads, dk), **f32),
                      torch.zeros((batch, n_heads), **f32))}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen, d_model: int, n_heads: int, device="cpu") -> Dict:
    dh = d_model // n_heads
    dff = int(math.ceil(4 * d_model / 3 / 64) * 64)
    return {
        "sl_conv": normal_init(gen, (CONV_W, d_model), fan_in=CONV_W, device=device),
        "sl_w": normal_init(gen, (d_model, 4 * d_model), device=device),
        "sl_r": normal_init(gen, (n_heads, dh, 4 * dh), fan_in=dh, device=device),
        "sl_b": torch.cat([torch.zeros(d_model, device=device),
                           torch.full((d_model,), 2.0, device=device),
                           torch.zeros(2 * d_model, device=device)]),
        "sl_up": normal_init(gen, (d_model, dff), device=device),
        "sl_upg": normal_init(gen, (d_model, dff), device=device),
        "sl_down": normal_init(gen, (dff, d_model), fan_in=dff, device=device),
    }


def apply_slstm(p: Dict, x: torch.Tensor, n_heads: int, cache: Optional[Dict] = None,
                mode: str = "train"):
    """(hidden, cache): the block's output (before the residual add) is
    ``hidden @ sl_down``.  The scan is a loop of S steps."""
    dtype = x.dtype
    b, s, d = x.shape
    dh = d // n_heads
    xc, new_conv = causal_conv(p["sl_conv"], x, None if cache is None else cache["conv"])
    xc = F.silu(xc)
    pre = (xc @ p["sl_w"].to(dtype)).float() + p["sl_b"].float()  # (B,S,4d)
    if cache is not None and "state" in cache:
        c, n, m, h = cache["state"]
    else:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c, n, m, h = zeros, torch.ones_like(zeros), zeros, zeros
    rw = p["sl_r"].float()  # (H, dh, 4dh)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, n_heads, dh), rw)
        # the per-head recurrent contributions into the i,f,z,o layout
        rcat = rec.reshape(b, n_heads, 4, dh).transpose(1, 2).reshape(b, 4 * d)
        it, ft, zt, ot = torch.chunk(pre[:, t] + rcat, 4, dim=-1)
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1)
    hseq = group_norm(hseq.reshape(b, s, n_heads, dh)).reshape(b, s, d).to(dtype)
    hidden = (hseq @ p["sl_up"].to(dtype)) * F.gelu(hseq @ p["sl_upg"].to(dtype),
                                                     approximate="tanh")
    new_cache = {"conv": new_conv, "state": (c, n, m, h)} if mode in ("prefill", "decode") else None
    return hidden, new_cache


def slstm_cache(batch: int, d_model: int, dtype, device) -> Dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, CONV_W - 1, d_model), dtype=dtype, device=device),
            "state": tuple(torch.zeros((batch, d_model), **f32) for _ in range(4))}
