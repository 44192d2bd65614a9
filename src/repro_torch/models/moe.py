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

``apply_moe_grid`` is the form on one rank of a GridMesh: the
experts sharded by the reference's rule (expert parallelism where the model
axis divides E, else tensor parallelism inside each expert), with the
reference's capacity and slots over the whole microbatch of the data ranks
(one all-gather of their counts).  Its combine sums each rank's weighted
expert outputs in f32 across the model axis and rounds once to the compute
dtype, where one card rounds each choice's product and the sum over the k
choices to it: in bf16 the output differs from one card's by up to one
bf16 rounding of each product (none in f32, where the two are the same
sums).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import normal_init
from repro_torch.models.mlp import apply_mlp, mlp_hidden, mlp_init


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


def _router(p: Dict, xf: torch.Tensor, cfg: MoEConfig):
    """xf (N, d) -> (logits (N,E) f32, probs (N,E), weights (N,k) f32,
    experts (N,k), sel (N,E) f32): the routing decisions.

    The router product runs in the compute dtype; the (N, E) logits, the
    softmax and the top-k in f32."""
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    sel = _one_hot(idx, cfg.n_experts, torch.float32).sum(dim=1)  # (N, E)
    return logits, probs, w, idx, sel


def _router_aux(cfg: MoEConfig, frac_routed, mean_prob, logits) -> Dict:
    """The Switch-style load-balance loss over the router distribution and
    the z loss (the mean of the squared log-normalizers), weighted."""
    lb = cfg.n_experts * torch.sum(frac_routed * mean_prob)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return {"moe_lb_loss": cfg.router_aux_weight * lb, "moe_z_loss": cfg.router_z_weight * z}


def _route(p: Dict, xf: torch.Tensor, cfg: MoEConfig):
    """xf (N, d) -> (weights (N,k) f32, experts (N,k), sel (N,E) f32, aux)."""
    logits, probs, w, idx, sel = _router(p, xf, cfg)
    aux = _router_aux(cfg, sel.mean(dim=0) / cfg.top_k, probs.mean(dim=0), logits)
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


def _grid_counts(pl, counts: torch.Tensor, n: int, cfg: MoEConfig):
    """(offset (E,), cap, total (E,), n_all) of one rank's call in
    ``apply_moe_grid``: where the rank's choices of each expert start among
    the slots, the slots per expert, the choices of each expert and the
    tokens over the call's ranks.  The microbatch source (no payload sink)
    takes the reference's whole microbatch: every data rank's counts (one
    all-gather), the offset of the data ranks before this one, whose rows
    come first in the group, and the capacity of all their tokens.  Under
    ``Placement.deferred`` (the data-axis source, which runs the loss on each
    data rank's rows alone) the rank's own."""
    if pl.sink is not None:
        return torch.zeros_like(counts), capacity(n, cfg), counts, n
    every = pl.data_counts(counts)
    n_all = n * every.shape[0]
    return every[:pl.data_index].sum(dim=0), capacity(n_all, cfg), every.sum(dim=0), n_all


def _mean_prob(pl, probs: torch.Tensor) -> torch.Tensor:
    """The rank's part of the load-balance loss's mean router probability
    (``apply_moe_grid``): its own rows' mean, which the ranks' mean of the
    loss turns into the mean over all rows."""
    return probs.mean(dim=0)


def apply_moe_grid(p: Dict, x: torch.Tensor, act: str, cfg: MoEConfig,
                   pl) -> Tuple[torch.Tensor, Dict]:
    """``apply_moe`` on one rank of a GridMesh (``pl``, a sharding/
    placement.py::Placement): x (B, S, d), the rank's rows, the same on
    each model rank of a data row -> (out (B, S, d), aux).  Train, prefill
    and decode alike: a decode step's one token a row routes with the
    capacity and slots of every data rank's rows, as the reference's
    single-program decode over the whole batch.

    Every rank routes its rows (the router gathered whole, its compute
    replicated over the model axis).  On the microbatch source the slots,
    the capacity and the load-balance fractions are the reference's over
    the whole microbatch (``_grid_counts``): a choice's slot is its
    exclusive prefix count in the group's token order, the data ranks' rows
    in rank order.  The load-balance loss, ``E sum_e frac_e mean_prob_e``,
    is linear in the probabilities once the fractions (top-k counts, no
    gradient) are global, so each rank takes its own rows' mean probability
    and the ranks' mean of the loss is the reference's, as is its gradient
    (the data axis's sum x 1/D); the z loss is a mean over tokens of the
    same form; the utilisation reads the global counts.  Under
    ``Placement.deferred`` every reading is the rank's own, as the
    reference's data-axis source computes them.

    The experts, by the placement's ``moe_mode`` (the reference's rule):
      * "ep": the rank's E/M experts whole (gathered over the data axis);
        it places only the choices of those experts in its buffer;
      * "tp": every expert's d_ff columns of the rank (``expert_wd``
        gathered whole and narrowed to its rows, as the dense ``wd``);
      * "rep": every expert whole on every rank, as one card.
    Split over the model axis, the region is column-parallel: the dispatch
    input and the combine weights are entered (their gradients summed over
    the model axis) and each rank combines its part of every token's
    output, in f32, summed over the model axis and cast once (``reduce``):
    the weighted sum rounds once where one card's rounds each product and
    each sum to the compute dtype (identical in f32).  No all-to-all:
    between the tensor-parallel regions the activations are replicated over
    the model axis, so each rank holds its data row's tokens already.  The
    shared experts take the dense MLP's tensor-parallel path where the
    placement splits d_ff (``mlp_tp``), else run replicated."""
    b, s, d = x.shape
    n = b * s
    dtype = x.dtype
    xf = x.reshape(n, d)
    e, k = cfg.n_experts, cfg.top_k
    logits, probs, w, idx, _ = _router(p, xf, cfg)
    flat_idx = idx.reshape(-1)
    onehot = _one_hot(flat_idx, e, torch.int64)  # (N*k, E)
    offset, cap, total, n_all = _grid_counts(pl, onehot.sum(dim=0), n, cfg)
    pos = torch.cumsum(onehot, dim=0) - onehot + offset  # exclusive prefix count, global
    pos = torch.gather(pos, 1, flat_idx[:, None])[:, 0]
    slot = torch.where(pos < cap, pos, cap)  # dropped -> sacrificial slot `cap`
    mode = pl.moe_mode
    el = e // pl.m if mode == "ep" else e  # the experts the rank computes
    local = flat_idx - pl.j * el if mode == "ep" else flat_idx
    row = local * (cap + 1) + slot
    if mode == "ep":  # another rank's expert: the pad row past the buffer
        row = torch.where((local >= 0) & (local < el), row, el * (cap + 1))
    split = mode != "rep"
    src = pl.enter(xf) if split else xf
    buf = torch.zeros((el * (cap + 1) + 1, d), dtype=src.dtype, device=x.device)
    buf = buf.scatter(0, row[:, None].expand(-1, d), src.repeat_interleave(k, dim=0))
    buf = buf[:-1].reshape(el, cap + 1, d)[:, :cap]

    if split:
        h = pl.expert_col_product(buf, p["expert_wi"], dtype)
        if act == "swiglu":
            h = F.silu(pl.expert_col_product(buf, p["expert_wg"], dtype)) * h
        else:
            h = F.gelu(h, approximate="tanh")
        out_buf = torch.bmm(h, p["expert_wd"].to(dtype)) if mode == "ep" else \
            pl.expert_row_product(h, p["expert_wd"])
    else:
        out_buf = _experts(p, buf, act)
    # combine: weighted gather; dropped choices and other ranks' experts
    # read zero rows
    out_buf = torch.cat([out_buf, out_buf.new_zeros((el, 1, d))], dim=1).reshape(-1, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    gathered = out_buf.index_select(0, row).reshape(n, k, d)
    if split:
        out = pl.reduce(torch.sum(gathered.float() * pl.enter(w)[..., None], dim=1)).to(dtype)
    else:
        out = torch.sum(gathered * w[..., None].to(dtype), dim=1)
    for key in sorted(p):
        if key.startswith("shared_"):
            if pl.mlp_tp:
                out = out + pl.row_product(mlp_hidden(p[key], xf, act, tp=pl), p[key]["wd"])
            else:
                out = out + apply_mlp(p[key], xf, act)
    aux = _router_aux(cfg, total.float() / n_all / k, _mean_prob(pl, probs), logits)
    aux["moe_util"] = torch.clamp(total.float(), max=cap).sum() / (e * cap)
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
