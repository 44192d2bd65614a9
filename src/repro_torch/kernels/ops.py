"""Adapters between the port's model and optimizer stacks and its kernels
(the counterpart of ``repro/kernels/ops.py``).

The attention adapters reshape the model's grouped query layout
(B, S, KV, G, D) to the kernels' (B, S, H, D) and back.  The flat-state
entries run the k-group moment carry (``moments_*_flat``, and the g-only
``g_accum_flat`` of stale-GSNR steps), the vmap stats method's stack
reduction (``vmap_moments_flat``) and the VR updates (``vr_scale_tree``
for VR-SGD/Momentum, ``vr_adam_update``, ``vr_lamb_update``,
``vr_lars_update``) over the ParamLayout flat buffers: one kernel wrapper
call each.  ``lamb_trust_flat``, the stale-step LAMB epilogue, is plain
torch, as the reference computes it outside any kernel (on a rank's rows:
plain partial sums, one all-reduce and the ``trust_apply`` kernel).  The GSNR ratio
derives from the raw group moments (stats.mean, stats.sq_mean) but
multiplies the gradient entering the update (``grads``, possibly
grad-clipped); moments are stored in ``state_dtype`` and the GSNR-momentum
bias correction uses the stats counter ``pt``.  Gradients, params, state
and updates are FlatBuffers.

Under a data mesh the VR updates and the moment carry take an ``spmd``
plan (backend.FlatSpmd), as in the reference (``_spmd_for(spmd,
layout)``): when the layout's flat buffer shards over the mesh, K3, K9, K4
and K10 run over the rank's rows of the carries (element-wise: the rows
equal the whole-buffer kernel's), the update runs per row shard
(kernels/flat_spmd.py with the collectives between the launches) on the
rank's rows of the moments, the gradient and the state, and the update
and scaled gradient come back as the rank's rows (FlatBuffers with a
``shard``); the params stay the whole replicated buffer.
"""
from __future__ import annotations

import torch

from repro_torch.core.baselines import _lamb_phi
from repro_torch.core.gsnr import GradStats
from repro_torch.core.layout import FlatBuffer, ParamLayout, leaf_sums, rows_of
from repro_torch.core.vrgd import bias_corrections
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu


def flash_attention(qh, k, v, q_pos=None, k_pos=None, *, q_seg=None, k_seg=None,
                    causal: bool = True, window: int = 0, train: bool = False):
    """qh (B,S,KV,G,D) against k, v (B,Skv,KV,D) -> (B,S,KV,G,D).  Omitted
    positions mean the implicit arange layout; segments are derived from the
    positions when not supplied.  ``train`` runs the autograd Function
    (forward and backward kernels, and the vmap rule that folds a vmapped
    dim into one launch), also where no gradient is recorded: a remat
    group's forward under ``torch.func`` runs its attention that way."""
    b, s, kvh, g, d = qh.shape
    fn = fa.flash_attention_train if train else fa.flash_attention
    out = fn(qh.reshape(b, s, kvh * g, d), k, v, q_pos, k_pos, q_seg, k_seg,
             causal=causal, window=window)
    return out.reshape(b, s, kvh, g, d)


def flash_decode(qh, k, v, q_pos, k_pos, q_seg, k_seg, *, causal: bool = True, window: int = 0,
                 with_lse: bool = False):
    """qh (B,L,KV,G,D) lanes against a paged (B,C,KV,D) cache ->
    (B,L,KV,G,D), or with ``with_lse`` (out, lse (B,L,KV*G) f32).  All four
    position/segment operands are required."""
    b, l, kvh, g, d = qh.shape
    out = fd.flash_decode(qh.reshape(b, l, kvh * g, d), k, v, q_pos, k_pos, q_seg, k_seg,
                          causal=causal, window=window, with_lse=with_lse)
    if with_lse:
        return out[0].reshape(b, l, kvh, g, d), out[1]
    return out.reshape(b, l, kvh, g, d)


def _spmd_for(spmd, layout: ParamLayout):
    """The plan when the layout's buffer shards over its mesh, else None
    (the single-card kernel on the replicated buffer)."""
    return spmd if (spmd is not None and spmd.supports(layout)) else None


def vr_scale_tree(stats: GradStats, grads: FlatBuffer, gamma: float, eps: float, spmd=None):
    """(r * grads, r) over the whole parameter set as one ``flat_vr_scale``
    call, both FlatBuffers (VR-SGD / VR-Momentum); under a sharding plan,
    the rank's rows of both (K13, an all-reduce, K14)."""
    layout = grads.layout
    plan = _spmd_for(spmd, layout)
    if plan is not None:
        sg, r = plan.vr_scale(stats.mean.data, grads.data, stats.sq_mean.data, layout,
                              gamma=gamma, eps=eps)
        shard = plan.shard(layout)
        return FlatBuffer(sg, layout, shard), FlatBuffer(r, layout, shard)
    sg, r = fu.flat_vr_scale(stats.mean.data, grads.data, stats.sq_mean.data, layout,
                             gamma=gamma, eps=eps)
    return FlatBuffer(sg, layout), FlatBuffer(r, layout)


def _state_plan(spmd, name, state):
    """(layout, shard, plan) of a flat state; raises when the state's form
    (rows of a shard, or the whole buffer) disagrees with the plan."""
    layout, shard = state["m"].layout, state["m"].shard
    plan = _spmd_for(spmd, layout)
    if (plan is None) != (shard is None):
        raise ValueError(f"{name}: the state is {'a row shard' if shard else 'replicated'} but "
                         f"the plan {'replicates' if plan is None else 'shards'} the buffer")
    return layout, shard, plan


def _adam_family(fn, name, grads, state, stats, lr, b1, b2, b3, eps, wd, gamma, gsnr_eps,
                 params, state_dtype, spmd):
    t, pt, bc1, bc2, bc3 = bias_corrections(state, b1, b2, b3)
    layout, shard, plan = _state_plan(spmd, name, state)
    fn = getattr(plan, name) if plan is not None else fn
    upd, m, v, p = fn(
        stats.mean.data, grads.data, stats.sq_mean.data, state["m"].data, state["v"].data,
        state["p"].data, params.data, (lr, bc1, bc2, bc3), layout,
        b1=b1, b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps,
        state_dtype=state_dtype,
    )
    new_state = {"step": t, "pt": pt, "m": FlatBuffer(m, layout, shard),
                 "v": FlatBuffer(v, layout, shard), "p": FlatBuffer(p, layout, shard)}
    return FlatBuffer(upd, layout, shard), new_state


def vr_adam_update(grads: FlatBuffer, state, stats: GradStats, lr, b1, b2, b3, eps, wd, gamma,
                   gsnr_eps, params, state_dtype: str = "float32", spmd=None):
    """The full VR-Adam update as one ``flat_vr_adam`` call (under a
    sharding plan: K13, an all-reduce, K15 over the rank's rows): returns
    (upd FlatBuffer, new state).  m, v, p are updated in place.  Without
    params the weight decay is skipped (zeros stand in for w), as in the
    reference."""
    if params is None:
        params, wd = FlatBuffer(grads.layout.zeros(grads.data.dtype, grads.data.device),
                                grads.layout), 0.0
    return _adam_family(fu.flat_vr_adam, "vr_adam", grads, state, stats, lr, b1, b2, b3, eps,
                        wd, gamma, gsnr_eps, params, state_dtype, spmd)


def vr_lamb_update(grads: FlatBuffer, state, stats: GradStats, lr, b1, b2, b3, eps, wd, gamma,
                   gsnr_eps, params: FlatBuffer, state_dtype: str = "float32", spmd=None):
    """The full VR-LAMB update as one ``flat_vr_lamb`` call (under a
    sharding plan: K13, an all-reduce, K16, an all-reduce, the trust
    epilogue over the rank's rows): returns (upd FlatBuffer, new state).
    m, v, p are updated in place."""
    return _adam_family(fu.flat_vr_lamb, "vr_lamb", grads, state, stats, lr, b1, b2, b3, eps,
                        wd, gamma, gsnr_eps, params, state_dtype, spmd)


def vr_lars_update(grads: FlatBuffer, state, stats: GradStats, lr, mu, wd, trust, gamma, eps,
                   params: FlatBuffer, spmd=None):
    """The full VR-LARS update as one ``flat_vr_lars`` call (under a
    sharding plan: K13, an all-reduce, K17, an all-reduce, the trust
    epilogue over the rank's rows): returns (upd FlatBuffer, new state).  m
    (f32) is updated in place."""
    layout, shard, plan = _state_plan(spmd, "vr_lars", state)
    fn = plan.vr_lars if plan is not None else fu.flat_vr_lars
    upd, m = fn(stats.mean.data, grads.data, stats.sq_mean.data, state["m"].data, params.data,
                (lr, gamma), layout, mu=mu, wd=wd, trust=trust, eps=eps)
    return (FlatBuffer(upd, layout, shard),
            {"step": state["step"] + 1, "m": FlatBuffer(m, layout, shard)})


def lamb_trust_flat(d: FlatBuffer, params: FlatBuffer, lr, wd, spmd=None) -> FlatBuffer:
    """The stale-step LAMB epilogue over the flat buffer, in plain torch:
    u = d + wd w, upd = -lr ratio_leaf u with the per-leaf norms summed by
    leaf id (the zero tail adds nothing).  When ``d`` holds a rank's rows,
    over those rows (``FlatSpmd.lamb_trust``: the partial sums, one
    all-reduce, ``trust_apply``)."""
    layout = d.layout
    if d.shard is not None:
        plan = _spmd_for(spmd, layout)
        if plan is None:
            raise ValueError("lamb_trust_flat: the direction is a row shard; pass its plan")
        return FlatBuffer(plan.lamb_trust(d.data, params.data, layout, lr=lr, wd=wd), layout,
                          d.shard)
    w = params.data
    u = d.data + wd * w
    un = torch.sqrt(leaf_sums(layout, u * u))
    pn = torch.sqrt(leaf_sums(layout, w * w))
    ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12), torch.ones_like(pn))
    return FlatBuffer(-lr * rows_of(layout, ratio) * u, layout)


def moments_init_flat(layout: ParamLayout, device, spmd=None):
    """Flat zero carries (g_sum, g2_sum) for the accumulation loop: the
    rank's rows under a sharding plan."""
    return flat_zeros(layout, device, spmd), flat_zeros(layout, device, spmd)


def flat_zeros(layout: ParamLayout, device, spmd=None) -> torch.Tensor:
    """A zero f32 carry: the whole buffer, or the rank's rows under a
    sharding plan."""
    plan = _spmd_for(spmd, layout)
    if plan is None:
        return layout.zeros(torch.float32, device)
    return plan.shard(layout).zeros(torch.float32, device)


def moments_accum_flat(g_sum, g2_sum, g, layout: ParamLayout = None, spmd=None):
    """One microbatch's flat gradient into both carries (one launch, in
    place); under a sharding plan the carries and ``g`` are the rank's rows
    and K3 runs over them."""
    plan = _spmd_for(spmd, layout)
    if plan is not None:
        return plan.moments_accum(g_sum, g2_sum, g, layout)
    return fs.flat_moments_accum(g_sum, g2_sum, g)


def g_accum_flat(g_sum, g, layout: ParamLayout = None, spmd=None):
    """One microbatch's flat gradient into the g-only carry of a stale-GSNR
    step (one launch, in place; the rank's rows under a sharding plan)."""
    plan = _spmd_for(spmd, layout)
    if plan is not None:
        return plan.g_accum(g_sum, g, layout)
    return fs.flat_g_accum(g_sum, g)


def _stats(mean, sq, k, layout, plan) -> GradStats:
    shard = None if plan is None else plan.shard(layout)
    return GradStats(mean=FlatBuffer(mean, layout, shard), sq_mean=FlatBuffer(sq, layout, shard),
                     k=k)


def vmap_moments_flat(gstack, k: int, layout: ParamLayout, spmd=None) -> GradStats:
    """The (k, n_rows, LANE) gradient stack of the vmap stats method ->
    GradStats of FlatBuffers (one launch); under a sharding plan the stack
    is (k, shard rows, LANE), the rank's rows of each slice, and K10 runs
    over them."""
    plan = _spmd_for(spmd, layout)
    if plan is not None:
        mean, sq = plan.vmap_moments(gstack, k, layout)
    else:
        mean, sq = fs.flat_vmap_moments(gstack, k)
    return _stats(mean, sq, k, layout, plan)


def moments_finalize_flat(g_sum, g2_sum, k: int, layout: ParamLayout, spmd=None) -> GradStats:
    """The /k normalize (one launch, in place) -> GradStats of FlatBuffers
    (the rank's rows under a sharding plan)."""
    plan = _spmd_for(spmd, layout)
    if plan is not None:
        mean, sq = plan.moments_finalize(g_sum, g2_sum, k, layout)
    else:
        mean, sq = fs.flat_moments_finalize(g_sum, g2_sum, k)
    return _stats(mean, sq, k, layout, plan)
