"""Mixture-of-Experts feed-forward: top-k router + capacity-bounded dispatch.

Port of ``repro/models/moe.py``.  Dispatch is the gather/scatter
("dropping") form: a token's position in its expert's buffer is an
exclusive cumsum over the routing one-hot, tokens beyond the capacity
``ceil(n k / E cf)`` (n: the tokens of this call, one microbatch when
training) go to a sacrificial slot ``cap`` that is sliced off, and the
combine is a weighted gather.  The expert products are batched GEMMs over
the (E, cap, d) buffer, as the reference's einsums are outside any kernel.

The scatter into the buffer writes every dropped token to the same
sacrificial row, so which one lands there is unspecified; that row is
sliced off before the experts run, so it reaches no output, and its
gradient is zero.  ``apply_moe_dense`` is the test oracle: every expert on
every token, no drops.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import normal_init
from repro_torch.models.mlp import apply_mlp, mlp_init


def moe_init(gen, d_model: int, d_ff: int, act: str, cfg: MoEConfig, device="cpu") -> Dict:
    e = cfg.n_experts
    p = {
        "router": normal_init(gen, (d_model, e), device=device),
        "expert_wi": normal_init(gen, (e, d_model, d_ff), fan_in=d_model, device=device),
        "expert_wd": normal_init(gen, (e, d_ff, d_model), fan_in=d_ff, device=device),
    }
    if act == "swiglu":
        p["expert_wg"] = normal_init(gen, (e, d_model, d_ff), fan_in=d_model, device=device)
    for i in range(cfg.n_shared_experts):
        p[f"shared_{i}"] = mlp_init(gen, d_model, d_ff, act, device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of ``idx`` by comparison (``F.one_hot`` checks the
    values on the host, which ``torch.func.vmap`` refuses)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: Dict, xf: torch.Tensor, cfg: MoEConfig):
    """xf (N, d) -> (weights (N,k) f32, experts (N,k), sel (N,E) f32, aux).

    The router product runs in the compute dtype; the (N, E) logits, the
    softmax and the top-k in f32."""
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss over the router distribution
    sel = _one_hot(idx, cfg.n_experts, torch.float32).sum(dim=1)  # (N, E)
    frac_routed = sel.mean(dim=0) / cfg.top_k
    lb = cfg.n_experts * torch.sum(frac_routed * probs.mean(dim=0))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"moe_lb_loss": cfg.router_aux_weight * lb, "moe_z_loss": cfg.router_z_weight * z}
    return w, idx, sel, aux


def _experts(p: Dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """(E, C, d) tokens -> (E, C, d) expert outputs (batched GEMMs)."""
    dtype = buf.dtype
    h = torch.bmm(buf, p["expert_wi"].to(dtype))
    if act == "swiglu":
        h = F.silu(torch.bmm(buf, p["expert_wg"].to(dtype))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["expert_wd"].to(dtype))


def _shared(p: Dict, xf: torch.Tensor, out: torch.Tensor, act: str) -> torch.Tensor:
    for key in sorted(p):
        if key.startswith("shared_"):
            out = out + apply_mlp(p[key], xf, act)
    return out


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    return int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def apply_moe(p: Dict, x: torch.Tensor, act: str, cfg: MoEConfig) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (out (B, S, d), aux {moe_lb_loss, moe_z_loss, moe_util})."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    w, idx, sel, aux = _route(p, xf, cfg)
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(n, cfg)

    # position of each (token, choice) in its expert's buffer
    flat_idx = idx.reshape(-1)
    onehot = _one_hot(flat_idx, e, torch.int64)  # (N*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot  # exclusive prefix count per expert
    pos = torch.gather(pos, 1, flat_idx[:, None])[:, 0]
    slot = torch.where(pos < cap, pos, cap)  # dropped -> sacrificial slot `cap`
    row = flat_idx * (cap + 1) + slot  # (N*k,) row of the (E*(cap+1), d) buffer

    src = xf.repeat_interleave(k, dim=0)  # token-major, choice-minor, as idx flattens
    buf = torch.zeros((e * (cap + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(0, row[:, None].expand(-1, d), src)
    buf = buf.reshape(e, cap + 1, d)[:, :cap]

    out_buf = _experts(p, buf, act)
    # combine: weighted gather; dropped choices read the zero pad row
    out_buf = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1).reshape(-1, d)
    gathered = out_buf.index_select(0, row).reshape(n, k, d)
    out = torch.sum(gathered * w[..., None].to(x.dtype), dim=1)
    out = _shared(p, xf, out, act)
    aux["moe_util"] = torch.clamp(sel.sum(dim=0), max=cap).sum() / (e * cap)
    return out.reshape(b, s, d), aux


def apply_moe_dense(p: Dict, x: torch.Tensor, act: str,
                    cfg: MoEConfig) -> Tuple[torch.Tensor, Dict]:
    """Oracle: every expert on every token, exact top-k combine, no drops."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, _sel, aux = _route(p, xf, cfg)
    e = cfg.n_experts
    all_out = _experts(p, xf[None].expand(e, -1, -1), act)  # (E, N, d)
    sel_out = torch.gather(all_out.transpose(0, 1), 1, idx[..., None].expand(-1, -1, d))
    out = torch.sum(sel_out * w[..., None].to(x.dtype), dim=1)
    out = _shared(p, xf, out, act)
    return out.reshape(b, s, d), aux
