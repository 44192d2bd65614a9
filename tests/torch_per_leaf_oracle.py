"""The per-leaf VR steps of the port: one kernel call (K18-K21) per
parameter leaf, the trust ratio from each leaf's norm sums, the counterpart
of tests/oracle.py's ``per_leaf_*`` over the JAX package's per-leaf kernels.

The port's own step is the flat one (``repro_torch.kernels.ops``); these
steps stay out of the package and are held against it by
tests/test_torch_per_leaf.py on the CPU and by chip_smoke.py's phase 12 on
the card.  Every argument that is a tree in the reference is a list of
leaves here (in layout order); each returns (updates, new state) as lists
and scalars.  Imports torch and the port only, no JAX.
"""
import torch

from repro_torch.core.baselines import _lamb_phi
from repro_torch.core.vrgd import bias_corrections
from repro_torch.kernels import vr_adam as va
from repro_torch.kernels import vr_lamb as vl
from repro_torch.kernels import vr_update as vu


def per_leaf_vr_scale(mean, sq_mean, grads, gamma, eps):
    """[(r * ga, r)] per leaf (VR-SGD's scaled gradient)."""
    return [vu.vr_scale(g, g2, gamma, eps, g_apply=ga) for g, g2, ga in zip(mean, sq_mean, grads)]


def per_leaf_vr_adam_update(grads, state, mean, sq_mean, lr, b1, b2, b3, eps, wd, gamma,
                            gsnr_eps, params, state_dtype="float32"):
    t, pt, bc1, bc2, bc3 = bias_corrections(state, b1, b2, b3)
    sd = getattr(torch, state_dtype)
    upd, ms, vs, ps = [], [], [], []
    for g, ga, g2, m, v, p, w in zip(mean, grads, sq_mean, state["m"], state["v"], state["p"],
                                     params):
        d, m_, v_, p_ = va.vr_adam_inner(g, g2, m, v, p, bc1, bc2, bc3, b1=b1, b2=b2, b3=b3,
                                         eps=eps, gamma=gamma, gsnr_eps=gsnr_eps, g_apply=ga)
        upd.append(-lr * (d + wd * w))
        ms.append(m_.to(sd))
        vs.append(v_.to(sd))
        ps.append(p_.to(sd))
    return upd, {"step": t, "pt": pt, "m": ms, "v": vs, "p": ps}


def per_leaf_vr_lamb_update(grads, state, mean, sq_mean, lr, b1, b2, b3, eps, wd, gamma,
                            gsnr_eps, params, state_dtype="float32"):
    t, pt, bc1, bc2, bc3 = bias_corrections(state, b1, b2, b3)
    sd = getattr(torch, state_dtype)
    upd, ms, vs, ps = [], [], [], []
    for g, ga, g2, m, v, p, w in zip(mean, grads, sq_mean, state["m"], state["v"], state["p"],
                                     params):
        u, m_, v_, p_, u2, w2 = vl.vr_lamb_inner(g, ga, g2, m, v, p, w, bc1, bc2, bc3, b1=b1,
                                                 b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma,
                                                 gsnr_eps=gsnr_eps)
        pn, un = torch.sqrt(w2), torch.sqrt(u2)
        ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12),
                            torch.ones_like(pn))
        upd.append(-lr * ratio * u)
        ms.append(m_.to(sd))
        vs.append(v_.to(sd))
        ps.append(p_.to(sd))
    return upd, {"step": t, "pt": pt, "m": ms, "v": vs, "p": ps}


def per_leaf_vr_lars_update(grads, state, mean, sq_mean, lr, mu, wd, trust, gamma, eps, params):
    ms = []
    for g, ga, g2, m, w in zip(mean, grads, sq_mean, state["m"], params):
        u, u2, w2 = vl.vr_lars_inner(g, ga, g2, w, wd=wd, gamma=gamma, eps=eps)
        pn, gn = torch.sqrt(w2), torch.sqrt(u2)
        ratio = torch.where((pn > 0) & (gn > 0), trust * pn / (gn + 1e-12), torch.ones_like(pn))
        ms.append(mu * m + ratio * u)
    return [-lr * m for m in ms], {"step": state["step"] + 1, "m": ms}
