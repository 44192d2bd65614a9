"""Per-row-shard flat VR updates: the CUDA kernels' wrappers and their plain
versions.

Counterpart of ``repro/kernels/flat_spmd.py``.  Under data parallelism each
rank holds a contiguous row range of the flat buffers (core/layout.py::
RowShard), and an update's per-leaf sums (the GSNR normalizer 1/mean(r),
the LAMB/LARS trust-ratio norms) combine across the ranks between launches
(backend.py::FlatSpmd):

  leaf_r_partials(g, g2, lids, leaf_slots)        -> racc             K13
  (all-reduce racc)
  vr_scale_apply(g, ga, g2, racc, lids, inv)      -> (sg, r)          K14
  vr_adam_apply(g, ga, g2, m, v, p, w, ...)       -> (upd, m', v', p') K15
  vr_lamb_compute(g, ga, g2, m, v, p, w, ...)     -> (u, m', v', p', acc) K16
  vr_lars_compute(g, ga, g2, w, ...)              -> (u, acc)         K17
  (LAMB, LARS: all-reduce acc)
  trust_apply(u, acc, lids, ...)                  -> upd (LARS: and m')

Every operand is the shard's: (rows, 128) buffers and ``lids``, its
(rows / 64,) int32 slice of the block-leaf-id map; ``inv`` is the layout's
(leaf_slots,) 1/size.  The accumulators are one f32 per leaf: ``racc``
(leaf_slots,) and ``acc`` (2, leaf_slots), the u^2 then the w^2 sums (the
reference keeps (leaf_slots, 128) lane rows; the sum over its lanes is the
port's entry).  The state (m, v, p in ``state_dtype``; LARS's m in f32) is
updated IN PLACE and returned, and ``trust_apply`` scales u in place into
the update.  The kernels (``csrc/flat_spmd.cu``) launch the same device
code as the single-card K5-K8 (``csrc/flat_update.cuh``), so the two paths
cannot drift; the plain versions share ``flat_update.raw_r`` and
``adam_chain``.  On a CUDA tensor each entry launches its kernel or raises;
on a CPU tensor it computes the plain version.  ``<entry>.launches`` counts
the calls that launched.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.backend import HOPPER, device_info
from repro_torch.core.baselines import _lamb_phi
from repro_torch.core.layout import FLAT_BLOCK_ROWS, LANE
from repro_torch.kernels import _build
from repro_torch.kernels.flat_update import STATE_DTYPES, _device, _stream, adam_chain, raw_r

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "spmd_leaf_r_partials": [_P] * 5 + [_I, _I, _F, _P],
    "spmd_vr_scale_apply": [_P] * 8 + [_I, _I, _F, _F, _P],
    "spmd_vr_adam_apply": [_P] * 11 + [_I, _I, _I] + [_F] * 11 + [_P],
    "spmd_vr_lamb_compute": [_P] * 13 + [_I, _I, _I] + [_F] * 10 + [_P],
    "spmd_vr_lars_compute": [_P] * 10 + [_I, _I, _F, _F, _F, _P],
    "spmd_lamb_apply": [_P] * 3 + [_I, _I, _F, _P],
    "spmd_lars_apply": [_P] * 4 + [_I, _I, _F, _F, _F, _P],
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _row_ids(lids: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) int64 leaf id of each row, from the per-block ids."""
    return lids.long().repeat_interleave(rows // lids.numel())


def shard_sums(x: torch.Tensor, lids: torch.Tensor, leaf_slots: int) -> torch.Tensor:
    """(leaf_slots,) f32 per-leaf sums of the shard's rows of x: the row sums
    added up in f64 and rounded once, as core/layout.py::leaf_sums does."""
    out = torch.zeros(leaf_slots, dtype=torch.float64, device=x.device)
    return out.index_add_(0, _row_ids(lids, x.shape[0]), x.float().sum(dim=1).double()).float()


def _ratio(g, g2, racc, lids, inv, gamma, gsnr_eps) -> torch.Tensor:
    """clip(r_raw / mean_leaf(r_raw), gamma, 1) with the leaf means from the
    combined ``racc``."""
    inv_mean = 1.0 / torch.clamp(racc * inv, min=1e-30)
    return torch.clamp(raw_r(g, g2, gsnr_eps) * inv_mean[_row_ids(lids, g.shape[0])][:, None],
                       gamma, 1.0)


def leaf_r_partials_ref(g, g2, lids, leaf_slots: int, *, gsnr_eps):
    """Plain version of ``leaf_r_partials``."""
    return shard_sums(raw_r(g, g2, gsnr_eps), lids, leaf_slots)


def vr_scale_apply_ref(g, ga, g2, racc, lids, inv, *, gamma, eps):
    """Plain version of ``vr_scale_apply``: (r * ga, r)."""
    r = _ratio(g, g2, racc, lids, inv, gamma, eps)
    return r * ga.float(), r


def _adam(g, ga, g2, m, v, p, w, scal, racc, lids, inv, b1, b2, b3, eps, wd, gamma, gsnr_eps):
    u, *new = adam_chain(_ratio(g, g2, racc, lids, inv, gamma, gsnr_eps), ga, m, v, p, w, scal,
                         b1, b2, b3, eps, wd)
    for d, n in zip((m, v, p), new):
        d.copy_(n)
    return u


def vr_adam_apply_ref(g, ga, g2, m, v, p, w, scal: Sequence[float], racc, lids, inv, *,
                      b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """Plain version of ``vr_adam_apply``; m, v, p are updated in place."""
    u = _adam(g, ga, g2, m, v, p, w, scal, racc, lids, inv, b1, b2, b3, eps, wd, gamma, gsnr_eps)
    return -float(scal[0]) * u, m, v, p


def vr_lamb_compute_ref(g, ga, g2, m, v, p, w, scal: Sequence[float], racc, lids, inv, *,
                        b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """Plain version of ``vr_lamb_compute``; m, v, p are updated in place."""
    u = _adam(g, ga, g2, m, v, p, w, scal, racc, lids, inv, b1, b2, b3, eps, wd, gamma, gsnr_eps)
    wf = w.float()
    acc = torch.stack((shard_sums(u * u, lids, racc.numel()),
                       shard_sums(wf * wf, lids, racc.numel())))
    return u, m, v, p, acc


def vr_lars_compute_ref(g, ga, g2, w, scal: Sequence[float], racc, lids, inv, *, wd, eps):
    """Plain version of ``vr_lars_compute``; scal = (lr, gamma)."""
    wf = w.float()
    u = _ratio(g, g2, racc, lids, inv, float(scal[1]), eps) * ga.float() + wd * wf
    acc = torch.stack((shard_sums(u * u, lids, racc.numel()),
                       shard_sums(wf * wf, lids, racc.numel())))
    return u, acc


def trust_from_partials(acc, *, numer_is_phi: bool, trust: float):
    """(leaf_slots,) trust ratio from the combined norm sums: LAMB
    clip(|w|, 0, 10) / (|u| + 1e-12), LARS trust |w| / (|u| + 1e-12), where
    both norms are > 0, else 1 (the reference's ``trust_from_partials``)."""
    un, pn = torch.sqrt(acc[0]), torch.sqrt(acc[1])
    numer = _lamb_phi(pn) if numer_is_phi else trust * pn
    return torch.where((pn > 0) & (un > 0), numer / (un + 1e-12), torch.ones_like(pn))


def trust_apply_ref(u, acc, lids, *, lr, lamb: bool, m=None, mu=0.0, trust=0.0):
    """Plain version of ``trust_apply``, in place on u (and LARS's m)."""
    ratio = trust_from_partials(acc, numer_is_phi=lamb, trust=trust)
    ratio = ratio[_row_ids(lids, u.shape[0])][:, None]
    if lamb:
        return u.mul_(-lr * ratio)
    m.copy_(mu * m + ratio * u)
    return torch.mul(m, -lr, out=u), m


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, lids, f32s, state=(), state_dtype=torch.float32, meta=()):
    """Raise unless every operand is contiguous on one Hopper card: ``f32s``
    f32 and ``state`` of ``state_dtype``, each (64 * len(lids), 128); lids
    int32; ``meta`` (accumulators, 1/size) f32."""
    shape, dev = (lids.numel() * FLAT_BLOCK_ROWS, LANE), f32s[0].device
    for t in (*f32s, *state):
        if tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: operands must be contiguous {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if any(t.dtype != torch.float32 for t in (*f32s, *meta)):
        raise TypeError(f"{name}: the buffers and accumulators must be float32")
    if state_dtype not in STATE_DTYPES or any(t.dtype != state_dtype for t in state):
        raise TypeError(f"{name}: the state must be {state_dtype} (one of {STATE_DTYPES})")
    for t in (lids, *meta):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: leaf ids and accumulators must be contiguous on {dev}")
    if lids.dtype != torch.int32 or lids.numel() == 0:
        raise TypeError(f"{name}: the leaf ids must be a non-empty int32 vector")
    capability = device_info(dev.index)[0]
    if capability != HOPPER:
        raise RuntimeError(f"{name}: the kernel is built for sm_90a (Hopper), got {capability}")


def _lib():
    return _build.library("flat_spmd", _SIGNATURES)


def leaf_r_partials(g, g2, lids, leaf_slots: int, *, gsnr_eps):
    """K13: the shard's per-leaf sums of r_raw = g^2 / (max(g2 - g^2, 0) +
    eps), a new (leaf_slots,) f32 tensor, each added up in f64 and rounded
    once, as K5-K8's first pass does; all-reduced across the shards it is
    that pass."""
    if not _device("leaf_r_partials", g):
        return leaf_r_partials_ref(g, g2, lids, leaf_slots, gsnr_eps=gsnr_eps)
    _check("leaf_r_partials", lids, (g, g2))
    racc = torch.empty(leaf_slots, dtype=torch.float32, device=g.device)
    # the blocks' f64 partial sums, then the last-block combine's ticket
    partials = torch.empty(lids.numel() + 1, dtype=torch.float64, device=g.device)
    err = _lib().spmd_leaf_r_partials(g.data_ptr(), g2.data_ptr(), lids.data_ptr(),
                                      racc.data_ptr(), partials.data_ptr(), leaf_slots,
                                      lids.numel(), gsnr_eps, _stream(g.device))
    _build.check(err, "leaf_r_partials")
    leaf_r_partials.launches += 1
    return racc


def vr_scale_apply(g, ga, g2, racc, lids, inv, *, gamma, eps):
    """K14: (r * ga, r) over the shard, r = clip(r_raw / mean_leaf(r_raw),
    gamma, 1) with the leaf means from the combined ``racc``."""
    if not _device("vr_scale_apply", g):
        return vr_scale_apply_ref(g, ga, g2, racc, lids, inv, gamma=gamma, eps=eps)
    _check("vr_scale_apply", lids, (g, ga, g2), meta=(racc, inv))
    sg, r = torch.empty_like(g), torch.empty_like(g)
    err = _lib().spmd_vr_scale_apply(g.data_ptr(), ga.data_ptr(), g2.data_ptr(), sg.data_ptr(),
                                     r.data_ptr(), lids.data_ptr(), inv.data_ptr(),
                                     racc.data_ptr(), racc.numel(), lids.numel(), gamma, eps,
                                     _stream(g.device))
    _build.check(err, "vr_scale_apply")
    vr_scale_apply.launches += 1
    return sg, r


def _norm_scratch(leaf_slots: int, n_blocks: int, dev):
    """A new (2, leaf_slots) f32 accumulator of the Σu² and Σw² sums (K16,
    K17), and the f64 scratch of their last-block combine: 2 n_blocks
    partial sums, then the ticket (zeroed by the entry)."""
    acc = torch.empty((2, leaf_slots), dtype=torch.float32, device=dev)
    return acc, torch.empty(2 * n_blocks + 1, dtype=torch.float64, device=dev)


def _adam_call(entry, name, g, ga, g2, m, v, p, w, scal, racc, lids, inv, h, state_dtype,
               with_lr):
    sd = getattr(torch, state_dtype)
    _check(name, lids, (g, ga, g2, w), (m, v, p), sd, meta=(racc, inv))
    lr, bc1, bc2, bc3 = (float(x) for x in scal[:4])
    out = torch.empty_like(g)
    head = (g.data_ptr(), ga.data_ptr(), g2.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.data_ptr(), w.data_ptr(), out.data_ptr(), lids.data_ptr(), inv.data_ptr(),
            racc.data_ptr())
    acc = None
    if not with_lr:
        acc, partials = _norm_scratch(racc.numel(), lids.numel(), g.device)
        head += (acc.data_ptr(), partials.data_ptr())
    tail = (racc.numel(), lids.numel(), int(sd == torch.bfloat16)) + ((lr,) if with_lr else ())
    err = getattr(_lib(), entry)(
        *head, *tail, bc1, bc2, bc3, h["b1"], h["b2"], h["b3"], h["eps"], h["wd"], h["gamma"],
        h["gsnr_eps"], _stream(g.device))
    _build.check(err, name)
    return out, acc


def vr_adam_apply(g, ga, g2, m, v, p, w, scal: Sequence[float], racc, lids, inv, *,
                  b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """K15: the shard's VR-Adam step: returns (upd, m', v', p') with upd =
    -lr (direction + wd w); scal = (lr, bc1, bc2, bc3) as host floats; m, v,
    p in ``state_dtype``, updated in place."""
    hyper = dict(b1=b1, b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps)
    if not _device("vr_adam_apply", g):
        return vr_adam_apply_ref(g, ga, g2, m, v, p, w, scal, racc, lids, inv, **hyper)
    upd, _ = _adam_call("spmd_vr_adam_apply", "vr_adam_apply", g, ga, g2, m, v, p, w, scal,
                        racc, lids, inv, hyper, state_dtype, with_lr=True)
    vr_adam_apply.launches += 1
    return upd, m, v, p


def vr_lamb_compute(g, ga, g2, m, v, p, w, scal: Sequence[float], racc, lids, inv, *,
                    b1, b2, b3, eps, wd, gamma, gsnr_eps, state_dtype="float32"):
    """K16: the shard's VR-LAMB step before the trust ratio: returns (u, m',
    v', p', acc) with u = direction + wd w and acc the shard's per-leaf sums
    of u^2 and w^2; m, v, p updated in place."""
    hyper = dict(b1=b1, b2=b2, b3=b3, eps=eps, wd=wd, gamma=gamma, gsnr_eps=gsnr_eps)
    if not _device("vr_lamb_compute", g):
        return vr_lamb_compute_ref(g, ga, g2, m, v, p, w, scal, racc, lids, inv, **hyper)
    u, acc = _adam_call("spmd_vr_lamb_compute", "vr_lamb_compute", g, ga, g2, m, v, p, w, scal,
                        racc, lids, inv, hyper, state_dtype, with_lr=False)
    vr_lamb_compute.launches += 1
    return u, m, v, p, acc


def vr_lars_compute(g, ga, g2, w, scal: Sequence[float], racc, lids, inv, *, wd, eps):
    """K17: the shard's VR-LARS step before the trust ratio: returns (u,
    acc) with u = r ga + wd w and acc the per-leaf sums of u^2 and w^2;
    scal = (lr, gamma) as host floats."""
    if not _device("vr_lars_compute", g):
        return vr_lars_compute_ref(g, ga, g2, w, scal, racc, lids, inv, wd=wd, eps=eps)
    _check("vr_lars_compute", lids, (g, ga, g2, w), meta=(racc, inv))
    u = torch.empty_like(g)
    acc, partials = _norm_scratch(racc.numel(), lids.numel(), g.device)
    err = _lib().spmd_vr_lars_compute(g.data_ptr(), ga.data_ptr(), g2.data_ptr(), w.data_ptr(),
                                      u.data_ptr(), lids.data_ptr(), inv.data_ptr(),
                                      racc.data_ptr(), acc.data_ptr(), partials.data_ptr(),
                                      racc.numel(), lids.numel(), float(scal[1]), wd, eps,
                                      _stream(g.device))
    _build.check(err, "vr_lars_compute")
    vr_lars_compute.launches += 1
    return u, acc


def trust_apply(u, acc, lids, *, lr, lamb: bool, m=None, mu=0.0, trust=0.0):
    """The trust-ratio epilogue from the combined ``acc``, in place: LAMB
    u <- -lr ratio_leaf u (returns the update); LARS m <- mu m + ratio_leaf
    u, u <- -lr m (returns (update, m)).  The reference computes it in jnp;
    the kernels are K5's and K7's last passes."""
    if not _device("trust_apply", u):
        return trust_apply_ref(u, acc, lids, lr=lr, lamb=lamb, m=m, mu=mu, trust=trust)
    _check("trust_apply", lids, (u,) if lamb else (u, m), meta=(acc,))
    n = acc.shape[-1]
    if lamb:
        err = _lib().spmd_lamb_apply(u.data_ptr(), lids.data_ptr(), acc.data_ptr(), n,
                                     lids.numel(), lr, _stream(u.device))
    else:
        err = _lib().spmd_lars_apply(m.data_ptr(), u.data_ptr(), lids.data_ptr(), acc.data_ptr(),
                                     n, lids.numel(), lr, mu, trust, _stream(u.device))
    _build.check(err, "trust_apply")
    trust_apply.launches += 1
    return u if lamb else (u, m)


leaf_r_partials.launches = 0
vr_scale_apply.launches = 0
vr_adam_apply.launches = 0
vr_lamb_compute.launches = 0
vr_lars_compute.launches = 0
trust_apply.launches = 0
