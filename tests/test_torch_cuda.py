"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device, so on a CPU-only
machine they count as skipped.  This file imports neither JAX nor the JAX
package, so it also runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs 2e-2 (one bf16 ulp at |x| < 4 — both sides do the
math in f32 from the same inputs and round the output); bf16 attention
gradients, which are far smaller, one ulp of their own scale (rtol 2^-7,
atol 2^-7 of the largest magnitude); f32 results 1e-4
(summation order over at most a few hundred terms); the moment carry is
exact up to one FMA rounding (rtol 1e-6); the VR-LAMB update rtol 1e-4
(its per-leaf sums are f32 atomics in another order), bf16 state one bf16
ulp (rtol 2^-7); the VR-Adam, VR-LARS and VR-scale updates likewise (rtol
1e-4, atol 1e-4 of the largest magnitude; bf16 state one ulp), and the
g-only carry exactly (the same f32 additions).  The data-parallel pieces:
the [g; g^2] payload exactly (one f32 product per element), the per-shard
update kernels K13-K17 and the trust epilogue as the single-card updates
(rtol 1e-4, atol 1e-4 of the largest magnitude; bf16 state one ulp).  The
vmap stats method: K10's mean exactly (the same f32 additions in order),
its sq_mean within one FMA rounding (rtol 1e-6); the vmap train step against
the scan step as the fused plan against the reference plan (rtol 1e-3).
The per-leaf kernels K18-K21 rtol 1e-4 with atol 1e-4 of the largest
magnitude (the prepass's mean and the kernels' norm sums in another order),
K22 and K23 as the flat carry.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backend import Backend
from repro_torch.configs import get_smoke
from repro_torch.core.layout import FlatBuffer, ParamLayout, RowShard, pad_mask
from repro_torch.data import lm_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flat_spmd as fsp
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu
from repro_torch.kernels import grad_stats as gs
from repro_torch.kernels import vr_adam as va
from repro_torch.kernels import vr_lamb as vl
from repro_torch.kernels import vr_update as vu
from repro_torch.models import init_params
from repro_torch.serve import Engine
from repro_torch.train import init_state, make_train_step

BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(b, s, rng):
    pos = np.full((b, s), -1, np.int32)
    for i in range(b):
        o, end = 0, s - int(rng.integers(0, s // 4))
        while o < end:
            n = int(rng.integers(1, min(90, end - o) + 1))
            pos[i, o:o + n] = np.arange(n)
            o += n
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.float32, 128)])
def test_flash_attention_kernel_matches_plain(dev, dtype, d):
    rng = np.random.default_rng(0)
    b, s, h, kvh = 2, 160, 4, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    pos = torch.from_numpy(_packed(b, s, rng)).to(dev)
    out, lse = fa.flash_attention(q, k, v, pos, pos, causal=True, window=37, with_lse=True)
    want, wlse = fa.attention_fwd_ref(q, k, v, causal=True, window=37, q_pos=pos, k_pos=pos)
    tol = BF16 if dtype == torch.bfloat16 else F32
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, wlse, **F32)
    assert bool((out[pos < 0] == 0).all())


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, causal=True)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), q.half(), q.half(), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 4])
def test_flash_decode_kernels_match_plain(dev, lanes):
    rng = np.random.default_rng(lanes)
    b, c, h, kvh, d = 4, 300, 8, 2, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
               for shape in ((b, lanes, h, d), (b, c, kvh, d), (b, c, kvh, d)))
    k_seg = np.where(np.arange(c) < 200, rng.integers(0, 2, size=(b, c)), -1).astype(np.int32)
    k_pos = np.full((b, c), -1, np.int32)
    for i in range(b):
        for seg in (0, 1):
            idx = np.nonzero(k_seg[i] == seg)[0]
            k_pos[i, idx] = np.arange(len(idx))
    q_seg = np.broadcast_to(np.arange(lanes) % 2, (b, lanes)).astype(np.int32).copy()
    q_pos = np.array([[int((k_seg[i] == q_seg[i, j]).sum()) for j in range(lanes)]
                      for i in range(b)], np.int32)
    q_pos[0, -1] = q_seg[0, -1] = -1  # an idle lane
    qp, kp, qs, ks = (torch.from_numpy(a).to(dev) for a in (q_pos, k_pos, q_seg, k_seg))
    m, l, acc = fd.flash_decode_split(q, k, v, qp, kp, qs, ks, causal=True, window=0, chunk=128)
    wm, wl, wacc = fd.decode_split_ref(q, k, v, qp, kp, qs, ks, causal=True, window=0, chunk=128)
    torch.testing.assert_close(l, wl, **F32)
    torch.testing.assert_close(acc, wacc, **F32)
    torch.testing.assert_close(m[wl > 0], wm[wl > 0], **F32)
    out = fd.flash_decode_combine(m, l, acc, torch.bfloat16)
    torch.testing.assert_close(out.float(), fd.decode_combine_ref(m, l, acc, torch.bfloat16).float(),
                               **BF16)
    full = fd.flash_decode(q, k, v, qp, kp, qs, ks)
    torch.testing.assert_close(full.float(), fd.decode_attention_ref(q, k, v, qp, kp, qs, ks).float(),
                               **BF16)
    assert bool((full[0, -1] == 0).all())


@pytest.mark.cuda
def test_engine_fused_plan_matches_reference_plan(dev):
    """granite-3-2b smoke (head_dim 64) in f32 on the card: the fused plan
    (both kernels) and the plain plan give the same greedy tokens, and the
    kernels ran on every layer."""
    cfg = get_smoke("granite-3-2b")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"))
    params = init_params(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(1).integers(0, cfg.model.vocab_size, size=(3, 12))
    fa.flash_attention.launches = fd.flash_decode_split.launches = 0
    fused = Engine(cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=Backend.all_fused())),
                   params, cache_len=32, device=dev).generate(prompts, 6)
    assert fa.flash_attention.launches == cfg.model.n_layers
    assert fd.flash_decode_split.launches == cfg.model.n_layers * 6
    ref = Engine(cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                          backend=Backend.all_reference())),
                 params, cache_len=32, device=dev).generate(prompts, 6)
    np.testing.assert_array_equal(fused.tokens, ref.tokens)
    np.testing.assert_allclose(fused.logprobs, ref.logprobs, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal", [(torch.bfloat16, 64, False), (torch.bfloat16, 128, True),
                                            (torch.float32, 128, True)])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, d, causal):
    rng = np.random.default_rng(7)
    b, s, h, kvh = 2, 160, 4, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))
    pos = torch.from_numpy(_packed(b, s, rng)).to(dev)
    seg = fa.segment_ids_from_positions(pos)
    out, lse = fa.flash_attention(q, k, v, pos, pos, seg, seg, causal=causal, window=37,
                                  with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fab.flash_attention_bwd(q, k, v, lse, delta, do, pos, pos, seg, seg, causal=causal,
                                  window=37)
    want = fab.attention_bwd_ref(q, k, v, lse, delta, do, causal=causal, window=37, q_pos=pos,
                                 k_pos=pos, q_seg=seg, k_seg=seg)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        tol = F32 if dtype == torch.float32 else \
            dict(atol=2.0**-7 * float(w.float().abs().max()), rtol=2.0**-7)
        torch.testing.assert_close(a.float(), w.float(), **tol)
    assert bool((got[0][pos < 0] == 0).all())


@pytest.mark.cuda
def test_flash_attention_function_matches_autograd_of_plain(dev):
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 128, 4, 64), dtype=np.float32)).to(dev)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fab.flash_attention_bwd.launches
    fa.flash_attention_train(*leaves, causal=False).backward(do)
    assert fab.flash_attention_bwd.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.attention_fwd_ref(*plain, causal=False)[0].backward(do)
    for a, w in zip(leaves, plain):
        torch.testing.assert_close(a.grad, w.grad, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_flat_kernels_match_plain(dev, state_dtype):
    rng = np.random.default_rng(9)
    tree = {"a": torch.empty(70000), "b": {"c": torch.empty(3, 5, 7), "d": torch.empty(4096)}}
    layout = ParamLayout.for_tree(tree)
    mask = pad_mask(layout, dev)

    def rand(scale=1.0, positive=False):
        x = torch.from_numpy(rng.standard_normal((layout.n_rows, 128), dtype=np.float32)).to(dev)
        x = x.abs() if positive else x
        return torch.where(mask, x * scale, 0.0)

    gs, g2s, g = rand(), rand(positive=True), rand()
    got = fs.flat_moments_accum(gs.clone(), g2s.clone(), g)
    want = fs.moments_accum_ref(gs.clone(), g2s.clone(), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=0)
    got = fs.flat_moments_finalize(*[t.clone() for t in want], 8)
    want = fs.moments_finalize_ref(*[t.clone() for t in want], 8)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)

    sd = getattr(torch, state_dtype)
    g = rand(0.1)
    g2 = g * g + rand(0.01, positive=True)
    ga, w = g * 0.7, rand(0.5)
    m, v, p = rand(0.01), rand(1e-3, positive=True), torch.where(mask, 0.5, 0.0)
    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12,
                 state_dtype=state_dtype)
    scal = (1e-3, 0.19, 0.002, 0.19)
    ks = [t.to(sd).clone() for t in (m, v, p)]
    ps = [t.to(sd).clone() for t in (m, v, p)]
    launches = fu.flat_vr_lamb.launches
    upd = fu.flat_vr_lamb(g, ga, g2, *ks, w, scal, layout, **hyper)[0]
    assert fu.flat_vr_lamb.launches == launches + 1
    want = fu.flat_vr_lamb_ref(g, ga, g2, *ps, w, scal, layout, **hyper)[0]
    torch.testing.assert_close(upd, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    tol = dict(rtol=1e-4, atol=1e-7) if state_dtype == "float32" else dict(rtol=2.0**-7, atol=1e-6)
    for a, b_ in zip(ks, ps):
        torch.testing.assert_close(a.float(), b_.float(), **tol)


def _flat_case(dev, seed):
    """A small multi-leaf layout, its pad mask and a generator of masked
    random flat buffers."""
    rng = np.random.default_rng(seed)
    tree = {"a": torch.empty(70000), "b": {"c": torch.empty(3, 5, 7), "d": torch.empty(4096)}}
    layout = ParamLayout.for_tree(tree)
    mask = pad_mask(layout, dev)

    def rand(scale=1.0, positive=False):
        x = torch.from_numpy(rng.standard_normal((layout.n_rows, 128), dtype=np.float32)).to(dev)
        x = x.abs() if positive else x
        return torch.where(mask, x * scale, 0.0)

    return layout, mask, rand


def _close_scaled(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vr_adam-float32", "vr_adam-bfloat16", "vr_lars",
                                    "vr_scale", "g_accum-float32", "g_accum-bfloat16"])
def test_flat_optimizer_kernels_match_plain(dev, kernel):
    """K6 (both state dtypes), K7, K8 and K9 against their plain versions,
    one launch counted per call; the zero tail as the plain version has it."""
    layout, mask, rand = _flat_case(dev, 10)
    g = rand(0.1)
    g2 = g * g + rand(0.01, positive=True)
    ga, w = g * 0.7, rand(0.5)
    name, _, dtype = kernel.partition("-")
    fn = {"vr_adam": fu.flat_vr_adam, "vr_lars": fu.flat_vr_lars, "vr_scale": fu.flat_vr_scale,
          "g_accum": fs.flat_g_accum}[name]
    before = fn.launches
    if name == "vr_adam":
        sd = getattr(torch, dtype)
        m, v, p = rand(0.01), rand(1e-3, positive=True), torch.where(mask, 0.5, 0.0)
        ks = [t.to(sd) for t in (m, v, p)]
        ps = [t.clone() for t in ks]
        hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-8, wd=0.01, gamma=0.1, gsnr_eps=1e-12,
                     state_dtype=dtype)
        scal = (1e-3, 0.19, 0.002, 0.19)
        upd = fu.flat_vr_adam(g, ga, g2, *ks, w, scal, layout, **hyper)[0]
        _close_scaled(upd, fu.flat_vr_adam_ref(g, ga, g2, *ps, w, scal, layout, **hyper)[0])
        tol = dict(rtol=1e-4, atol=1e-7) if dtype == "float32" else dict(rtol=2.0**-7, atol=1e-6)
        for a, b_ in zip(ks, ps):
            torch.testing.assert_close(a.float(), b_.float(), **tol)
    elif name == "vr_lars":
        m = rand(0.01)
        hyper = dict(mu=0.9, wd=1e-4, trust=0.001, eps=1e-12)
        km, pm = m.clone(), m.clone()
        upd, km2 = fu.flat_vr_lars(g, ga, g2, km, w, (0.05, 0.1), layout, **hyper)
        want, pm2 = fu.flat_vr_lars_ref(g, ga, g2, pm, w, (0.05, 0.1), layout, **hyper)
        assert km2 is km
        _close_scaled(upd, want)
        _close_scaled(km, pm)
    elif name == "vr_scale":
        sg, r = fu.flat_vr_scale(g, ga, g2, layout, gamma=0.1, eps=1e-12)
        wsg, wr = fu.flat_vr_scale_ref(g, ga, g2, layout, gamma=0.1, eps=1e-12)
        _close_scaled(sg, wsg)
        _close_scaled(r, wr)
        assert bool((r[~mask] == 0.1).all()) and bool((sg[~mask] == 0).all())
    else:
        gs, gg = rand(), rand().to(getattr(torch, dtype))
        got = fs.flat_g_accum(gs.clone(), gg)
        torch.testing.assert_close(got, fs.g_accum_ref(gs.clone(), gg), rtol=0, atol=0)
    assert fn.launches == before + 1


@pytest.mark.cuda
def test_pack_square_kernel_matches_plain(dev):
    """K11: the [g; g^2] payload, exactly, one launch."""
    layout, _, rand = _flat_case(dev, 11)
    g = rand()
    before = fs.flat_pack_square.launches
    got = fs.flat_pack_square(g)
    assert fs.flat_pack_square.launches == before + 1 and got.shape == (2, layout.n_rows, 128)
    torch.testing.assert_close(got, fs.pack_square_ref(g), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_spmd_kernels_match_plain(dev, state_dtype):
    """K13-K17 and the trust epilogue on each of three row shards (11
    blocks: the last shard is padded, the first leaf straddles both
    boundaries), the partials summed in rank order as the all-reduce would;
    one launch counted per call."""
    layout, mask, rand = _flat_case(dev, 12)
    g = rand(0.1)
    g2 = g * g + rand(0.01, positive=True)
    ga, w, m0 = g * 0.7, rand(0.5), rand(0.01)
    v0, p0 = rand(1e-3, positive=True), torch.where(mask, 0.5, 0.0)
    sd = getattr(torch, state_dtype)
    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-8, wd=0.01, gamma=0.1, gsnr_eps=1e-12,
                 state_dtype=state_dtype)
    scal, lscal = (1e-3, 0.19, 0.002, 0.19), (0.05, 0.1)
    state_tol = dict(rtol=1e-4, atol=1e-7) if state_dtype == "float32" else \
        dict(rtol=2.0**-7, atol=1e-6)
    shards = [RowShard(layout, 3, s) for s in range(3)]
    assert shards[-1].pad_blocks == 1
    loc = [{k: sh.local(t) for k, t in dict(g=g, g2=g2, ga=ga, w=w, m=m0, v=v0, p=p0).items()}
           for sh in shards]
    ids = [sh.device_meta(dev) for sh in shards]
    kernels = (fsp.leaf_r_partials, fsp.vr_scale_apply, fsp.vr_adam_apply, fsp.vr_lamb_compute,
               fsp.vr_lars_compute, fsp.trust_apply)
    before = [fn.launches for fn in kernels]
    parts = [fsp.leaf_r_partials(a["g"], a["g2"], i["block_leaf_ids"], layout.leaf_slots,
                                 gsnr_eps=1e-12) for a, i in zip(loc, ids)]
    for a, i, got in zip(loc, ids, parts):
        want = fsp.leaf_r_partials_ref(a["g"], a["g2"], i["block_leaf_ids"], layout.leaf_slots,
                                       gsnr_eps=1e-12)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    racc = parts[0] + parts[1] + parts[2]
    lamb_accs, lars_accs, us = [], [], []
    for a, i in zip(loc, ids):
        lids, inv = i["block_leaf_ids"], i["inv_sizes"]
        got = fsp.vr_scale_apply(a["g"], a["ga"], a["g2"], racc, lids, inv, gamma=0.1, eps=1e-12)
        want = fsp.vr_scale_apply_ref(a["g"], a["ga"], a["g2"], racc, lids, inv, gamma=0.1,
                                      eps=1e-12)
        for x, y in zip(got, want):
            _close_scaled(x, y)
        for fn, ref in ((fsp.vr_adam_apply, fsp.vr_adam_apply_ref),
                        (fsp.vr_lamb_compute, fsp.vr_lamb_compute_ref)):
            ks = [a[k].to(sd, copy=True) for k in "mvp"]
            ps = [t.clone() for t in ks]
            got = fn(a["g"], a["ga"], a["g2"], *ks, a["w"], scal, racc, lids, inv, **hyper)
            want = ref(a["g"], a["ga"], a["g2"], *ps, a["w"], scal, racc, lids, inv, **hyper)
            _close_scaled(got[0], want[0])
            for x, y in zip(ks, ps):
                torch.testing.assert_close(x.float(), y.float(), **state_tol)
            if fn is fsp.vr_lamb_compute:
                torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=0)
                lamb_accs.append(got[4])
                us.append(got[0])
        got = fsp.vr_lars_compute(a["g"], a["ga"], a["g2"], a["w"], lscal, racc, lids, inv,
                                  wd=1e-4, eps=1e-12)
        want = fsp.vr_lars_compute_ref(a["g"], a["ga"], a["g2"], a["w"], lscal, racc, lids, inv,
                                       wd=1e-4, eps=1e-12)
        _close_scaled(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0)
        lars_accs.append(got)
    acc = lamb_accs[0] + lamb_accs[1] + lamb_accs[2]
    for u, i in zip(us, ids):
        got = fsp.trust_apply(u.clone(), acc, i["block_leaf_ids"], lr=1e-3, lamb=True)
        _close_scaled(got, fsp.trust_apply_ref(u.clone(), acc, i["block_leaf_ids"], lr=1e-3,
                                               lamb=True))
    acc = lars_accs[0][1] + lars_accs[1][1] + lars_accs[2][1]
    for (u, _), a, i in zip(lars_accs, loc, ids):
        kw = dict(lr=0.05, lamb=False, mu=0.9, trust=0.001)
        got = fsp.trust_apply(u.clone(), acc, i["block_leaf_ids"], m=a["m"].clone(), **kw)
        want = fsp.trust_apply_ref(u.clone(), acc, i["block_leaf_ids"], m=a["m"].clone(), **kw)
        for x, y in zip(got, want):
            _close_scaled(x, y)
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [3, 3, 3, 3, 3, 6]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vr_sgd", "vr_adam"])
def test_fused_vr_steps_keep_flat_state_on_the_card(dev, name):
    """One fused smoke step of vr_sgd (K8) or vr_adam (K6): flat state on the
    card, one launch of the optimizer's kernel and none of the others, and
    the same params as the plain plan after the step."""
    cfg = get_smoke("bert-large")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"),
                      optimizer=dataclasses.replace(cfg.optimizer, name=name))
    params = init_params(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = next(lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len))
    kernels = (fu.flat_vr_scale, fu.flat_vr_adam, fu.flat_vr_lamb, fu.flat_vr_lars)
    own = fu.flat_vr_scale if name == "vr_sgd" else fu.flat_vr_adam
    out = {}
    for plan, bk in (("fused", Backend.all_fused()), ("reference", Backend.all_reference())):
        pc = cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=bk))
        state = init_state(pc, params=params, device=dev)
        before = [fn.launches for fn in kernels]
        state, _ = make_train_step(pc, device=dev)[0](state, batch)
        delta = [fn.launches - b for fn, b in zip(kernels, before)]
        if plan == "fused":
            assert delta == [int(fn is own) for fn in kernels]
            for key in ("m", "v", "p"):
                if key in state.opt_state:
                    x = state.opt_state[key]
                    assert isinstance(x, FlatBuffer) and x.data.device.type == "cuda"
        else:
            assert delta == [0] * len(kernels)
        out[plan] = state.params.data.clone()
    torch.testing.assert_close(out["fused"], out["reference"], rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_default_optimizer_keeps_flat_state_on_the_card(dev):
    """make_optimizer(cfg) on the default (auto) plan gives flat m/v/p for
    params on the card, and its update launches K5."""
    from repro_torch.core.gsnr import GradStats
    from repro_torch.core.layout import FlatBuffer, FlatParams, is_flat
    from repro_torch.core.vrgd import make_optimizer

    cfg = get_smoke("bert-large")
    flat = FlatParams(init_params(cfg.model, torch.Generator(device=dev).manual_seed(0),
                                  device=dev), cfg.model.n_groups(), device=dev)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(flat)
    assert all(is_flat(state[k]) for k in ("m", "v", "p"))
    w = FlatBuffer(flat.data, flat.layout)
    g = FlatBuffer(torch.full_like(flat.data, 1e-3), flat.layout)
    g2 = FlatBuffer(torch.full_like(flat.data, 2e-6), flat.layout)
    launches = fu.flat_vr_lamb.launches
    opt.update(g, state, w, stats=GradStats(g, g2, 8))
    assert fu.flat_vr_lamb.launches == launches + 1


@pytest.mark.cuda
def test_train_step_fused_matches_reference_on_card(dev):
    """bert-large smoke in f32 on the card: three VR-LAMB steps through the
    kernels (K1, K2, K3, K4, K5) agree with the plain plan, and every kernel
    ran its expected count per step."""
    cfg = get_smoke("bert-large")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"))
    params = init_params(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    runs = {}
    for plan in ("fused", "reference"):
        pc = cfg.replace(parallel=dataclasses.replace(
            cfg.parallel, backend=Backend.all_fused() if plan == "fused" else Backend.all_reference()))
        state = init_state(pc, params=params, device=dev)
        step = make_train_step(pc, log_gsnr=True, device=dev)[0]
        batches = lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len)
        hist = []
        for _ in range(3):
            counts = (fa.flash_attention.launches, fab.flash_attention_bwd.launches,
                      fs.flat_moments_accum.launches, fs.flat_moments_finalize.launches,
                      fu.flat_vr_lamb.launches)
            state, metrics = step(state, next(batches))
            delta = tuple(n - c for n, c in zip(
                (fa.flash_attention.launches, fab.flash_attention_bwd.launches,
                 fs.flat_moments_accum.launches, fs.flat_moments_finalize.launches,
                 fu.flat_vr_lamb.launches), counts))
            k, n = cfg.optimizer.k, cfg.model.n_layers
            assert delta == ((2 * n * k, n * k, k, 1, 1) if plan == "fused" else (0,) * 5)
            hist.append({key: float(val) for key, val in metrics.items()})
        runs[plan] = (hist, state.params.data.clone())
    for a, b_ in zip(runs["fused"][0], runs["reference"][0]):
        for key in ("loss", "grad_norm", "update_norm", "gsnr/mean", "gsnr/frac_floor"):
            np.testing.assert_allclose(a[key], b_[key], rtol=1e-3, atol=5e-4, err_msg=key)
    torch.testing.assert_close(runs["fused"][1], runs["reference"][1], rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 7])
def test_vmap_moments_kernel_matches_plain(dev, k):
    layout = ParamLayout.for_tree({"w": torch.zeros(517), "e": torch.zeros(64, 129),
                                   "t": torch.zeros(3, 5, 7)})
    mask = pad_mask(layout, dev)
    gen = torch.Generator(device=dev).manual_seed(k)
    gstack = torch.randn((k, layout.n_rows, 128), generator=gen, device=dev) * mask
    launches = fs.flat_vmap_moments.launches
    mean, sq = fs.flat_vmap_moments(gstack, k)
    assert fs.flat_vmap_moments.launches == launches + 1
    want_m, want_sq = fs.vmap_moments_ref(gstack, k)
    torch.testing.assert_close(mean, want_m, rtol=0, atol=0)
    torch.testing.assert_close(sq, want_sq, rtol=1e-6, atol=0)
    assert not mean[~mask].any() and not sq[~mask].any()


def _leaf_inputs(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(scale, positive=False):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.abs() if positive else x

    g = r(1e-2)
    return dict(g=g, ga=g * 0.7, g2=g * g + r(1e-4, True), m=r(1e-3), v=r(1e-5, True),
                p=r(1.0, True).clamp(max=1.0), w=r(0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 5), (70000,), (24, 64, 256)])
def test_per_leaf_kernels_match_plain(dev, shape):
    x = _leaf_inputs(dev, shape, 3)
    bc = (0.19, 0.002, 0.19)
    adam = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, gamma=0.1, gsnr_eps=1e-12)
    cases = {
        "vr_scale": (vu.vr_scale, vu.vr_scale_ref, (x["g"], x["g2"], 0.1, 1e-12),
                     dict(g_apply=x["ga"])),
        "vr_adam_inner": (va.vr_adam_inner, va.vr_adam_inner_ref,
                          (x["g"], x["g2"], x["m"], x["v"], x["p"], *bc),
                          dict(g_apply=x["ga"], **adam)),
        "vr_lamb_inner": (vl.vr_lamb_inner, vl.vr_lamb_inner_ref,
                          (x["g"], x["ga"], x["g2"], x["m"], x["v"], x["p"], x["w"], *bc),
                          dict(wd=0.01, **adam)),
        "vr_lars_inner": (vl.vr_lars_inner, vl.vr_lars_inner_ref,
                          (x["g"], x["ga"], x["g2"], x["w"]), dict(wd=1e-4, gamma=0.1, eps=1e-12)),
    }
    for name, (kernel, plain, args, kw) in cases.items():
        launches = kernel.launches
        got = kernel(*args, **kw)
        assert kernel.launches == launches + 1, name
        for a, b in zip(got, plain(*args, **kw)):
            assert a.shape == b.shape and a.dtype == torch.float32, name
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()),
                                       msg=name)
    # K22 / K23: k bf16 microbatches into the padded carry, then /k
    carry = (gs.moments_init(x["g"]), gs.moments_init(x["g"]))
    plain = tuple(t.clone() for t in carry)
    for i in range(3):
        g = (x["g"] * (i + 1)).to(torch.bfloat16)
        gs.moments_accum(*carry, g)
        gs.moments_accum_ref(*plain, g)
    torch.testing.assert_close(carry[0], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(carry[1], plain[1], rtol=1e-6, atol=0)
    want = gs.moments_finalize_ref(*(t.clone() for t in carry), 3, shape)  # the same carry
    for a, b in zip(gs.moments_finalize(*carry, 3, shape), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_vmap_train_step_matches_scan_on_card(dev):
    """bert-large smoke in f32 on the card: a fresh then a stale VR-LAMB step
    with stats_method="vmap" launches K1 2n, K2 n and K10 once (nothing of
    K3/K4/K9) and agrees with the scan step."""
    import warnings

    cfg = get_smoke("bert-large")
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32",
                                                   backend=Backend.all_fused()))
    params = init_params(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    counters = (fa.flash_attention, fab.flash_attention_bwd, fs.flat_vmap_moments,
                fs.flat_moments_accum, fs.flat_moments_finalize, fs.flat_g_accum)
    n = cfg.model.n_layers
    runs = {}
    for method in ("vmap", "scan"):
        pc = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, stats_method=method))
        state = init_state(pc, params=params, device=dev)
        step = make_train_step(pc, log_gsnr=True, device=dev)[0]
        batches = lm_batches(cfg.model.vocab_size, cfg.global_batch, cfg.seq_len)
        hist = []
        for with_stats in (True, False):
            before = [c.launches for c in counters]
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message="There is a performance drop")
                state, metrics = step(state, next(batches), with_stats)
            delta = tuple(c.launches - b for c, b in zip(counters, before))
            if method == "vmap":
                assert delta == (2 * n, n, int(with_stats), 0, 0, 0), delta
            hist.append({key: float(val) for key, val in metrics.items()})
        runs[method] = (hist, state.params.data.clone())
    for a, b_ in zip(runs["vmap"][0], runs["scan"][0]):
        for key in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(a[key], b_[key], rtol=1e-3, err_msg=key)
    torch.testing.assert_close(runs["vmap"][1], runs["scan"][1], rtol=2e-4, atol=2e-5)
