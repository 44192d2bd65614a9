#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   — the card's name and power limit (nvidia-smi), capability
                (9, 0), TF32 off for float32 products.
  2. build    — compile every CUDA kernel of the port from
                src/repro_torch/kernels/csrc with nvcc (sm_90a).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the shapes the serving path gives it; times (median of
                CUDA-event runs) of the kernel, the plain version and, as a
                yardstick only, one PyTorch library call; the least time
                the card could take (bound).
  4. engine   — internlm2-1.8b at full width (random weights from a seeded
                generator) through Engine.generate: batch 8, prompt 512,
                32 new tokens; launch counts of every kernel in that run.
  5. reference — the same weights through the plain ("reference") attention
                plan: prefill logits and greedy tokens agree.
  6. continuous — ContinuousEngine at full width drains 8 requests.
  7. train kernels — the training slice's kernels against their plain
                versions at the shapes its main path gives them (K10, the
                vmap path's stack reduction, at k = 8 and 7 too): the
                attention forward with its LSE and the attention backward (bert-large's B=32 S=128 H=16 D=64
                bidirectional, internlm2-1.8b's B=8 S=512 H=16/8 D=128
                causal packed with pads, and through the autograd
                Function), the flat moment carry, the g-only carry and the
                flat VR-LAMB, VR-Adam (f32 and bf16 state), VR-LARS and
                VR-scale updates on bert-large's full flat layout; times
                beside bounds, plain versions and library calls.
  8. train    — bert-large at published width and depth (seeded random
                weights), seq 128, global batch 256, k=8: three VR-LAMB
                steps through make_train_step on the fused plan (every
                kernel, launch counts asserted per step) and three on the
                reference plan (plain versions) from the same params and
                batches, compared step by step; step time, tokens/s and a
                torch.profiler breakdown of one more fused step.
  9. train optimizers — the same model and cut: two fresh steps of each of
                VR-Adam, VR-LARS, VR-SGD and VR-Momentum on each plan; a
                fresh then a stale step (gsnr_refresh 2) of VR-Adam and
                VR-LAMB, the reference plan through train_loop; one LAMB
                baseline step (a single backward over the whole batch).
                Launch counts asserted per fused step, the plans compared
                within TRAIN_TOL, warm step times and tokens/s.
 10. data parallel — (a) the data-parallel kernels at the main path's
                shapes: the [g; g^2] payload (K11) on bert-large's full flat
                layout, and the per-row-shard update kernels (K13-K17) with
                the trust epilogue on that layout split into 4 row shards in
                this process (the partials added in place of the all-reduce),
                each against its plain version and, put together, against
                the single-card K5-K8; times beside bounds.  (b) bert-large
                at full width trained by ranks that share the card over gloo
                (one process per rank): two ranks at global batch 64 (three
                VR-LAMB steps, one each of VR-Adam, VR-LARS and VR-SGD)
                against single-card k=2 steps, and four ranks at global
                batch 128 (three VR-LAMB steps) against single-card k=4;
                launch counts per rank per step, params bit-identical across
                the ranks after every step, agreement within DP_TOL, step
                and collective walls, peak memory per rank.
 11. train vmap — phase 8's model, cut and batches with stats_method="vmap"
                (one vmapped forward and backward over the k groups, the
                gradient stack reduced by K10): three fresh VR-LAMB steps and
                a stale one on the fused plan (launches asserted per step:
                K1 48, K2 24, K10 1, K5 1; functorch's fallback warning an
                error) against the reference plan (TRAIN_TOL) and phase 8's
                scan steps (VMAP_TOL); step wall, tokens/s, peak memory and a
                profile beside phase 8's; two fresh VR-Adam steps (K1 48, K2
                24, K10 1, K6 1) against the reference plan (TRAIN_TOL).
                Runs right after phase 8.
 12. per leaf — the per-leaf kernels K18-K23 against their plain versions
                at bert-large's largest stacked leaf (24, 1024, 4096), times
                beside bounds; then the per-leaf path over bert-large's
                layout: the k-microbatch carry leaf by leaf (K22, K23)
                against the flat carry (K3, K4) and the per-leaf VR-scale,
                VR-Adam, VR-LAMB and VR-LARS steps (K18-K21) against the flat
                K8, K6, K5, K7 steps from the same inputs.

The second-last lines are the kernel JSON record and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores

# Stated tolerances.  Kernel and plain version both do the math in f32 from
# the same inputs; they differ only in summation order and exp rounding
# (~1e-6 relative), so f32 results (lse, partials) agree to 1e-4.  A bf16
# output can then round to a neighbouring value: 1 bf16 ulp is 2^-7 of the
# magnitude, and outputs here stay below 4, hence 2e-2.
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16_OUT = dict(atol=2e-2, rtol=2e-2)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_close(name, got, want, tol):
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    max_err = float(err.max())
    print(f"  {name}: max_abs_err={max_err:.3e} tol(atol={tol['atol']}, rtol={tol['rtol']}) "
          f"{'ok' if not bad.any() else 'FAIL'}", flush=True)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside tolerance")
    return max_err


def cuda_ms(fn, iters: int = 25) -> float:
    """Device time of fn(): the call is captured once in a CUDA graph, and the
    median over ``iters`` replays, each between two CUDA events, is taken.
    Replaying leaves out the host's time to issue the calls, which for small
    kernels would otherwise be what the events measure."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 3 inputs
# ---------------------------------------------------------------------------


def packed_positions(b, s, rng):
    """(B, S) positions: per row several documents restarting at 0, then a
    padded tail (-1) of a different length per row."""
    pos = np.full((b, s), -1, np.int32)
    for i in range(b):
        o = 0
        end = s - int(rng.integers(0, s // 4))
        while o < end:
            n = int(rng.integers(1, min(200, end - o) + 1))
            pos[i, o:o + n] = np.arange(n)
            o += n
    return pos


def paged_cache(b, c, lanes, n_fill, rng):
    """An arrival-ordered cache: n_fill slots holding two interleaved
    documents per row (segments 0/1), the rest empty (-1); lane l continues
    document l % 2, and the last lane of the first two rows is idle."""
    k_pos = np.full((b, c), -1, np.int32)
    k_seg = np.full((b, c), -1, np.int32)
    counts = np.zeros((b, 2), np.int32)
    for i in range(b):
        for s in range(n_fill):
            seg = int(rng.integers(0, 2))
            k_seg[i, s] = seg
            k_pos[i, s] = counts[i, seg]
            counts[i, seg] += 1
    q_seg = np.broadcast_to(np.arange(lanes, dtype=np.int32) % 2, (b, lanes)).copy()
    q_pos = counts[np.arange(b)[:, None], q_seg].astype(np.int32)
    q_pos[:2, -1] = -1
    q_seg[:2, -1] = -1
    return q_pos, k_pos, q_seg, k_seg


def phase_kernels(records):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1 flash_attention_fwd ------------------------------------------
    print("[kernels] flash_attention_fwd", flush=True)
    b, s, h, kvh, d = 8, 512, 16, 8, 128
    q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
    main_err = 0.0
    for with_lse in (False, True):
        got = fa.flash_attention(q, k, v, causal=True, with_lse=with_lse)
        want = fa.attention_fwd_ref(q, k, v, causal=True)
        if with_lse:
            main_err = max(main_err, check_close("main B8 S512 bf16 causal out (lse run)",
                                                 got[0], want[0], TOL_BF16_OUT))
            check_close("main lse", got[1], want[1], TOL_F32)
        else:
            main_err = max(main_err, check_close("main B8 S512 bf16 causal out", got, want[0],
                                                 TOL_BF16_OUT))
    qp, kp, qs, ks = fa.resolve_positions(None, None, s, s, device=dev)
    qp, qs = qp.expand(b, s).contiguous(), qs.expand(b, s).contiguous()
    mask = fa.attention_mask(qp, qp, qs, qs, causal=True)
    pairs = int(mask.sum()) * h
    t_kernel = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    t_plain = cuda_ms(lambda: fa.attention_fwd_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = kt.repeat_interleave(h // kvh, dim=1), vt.repeat_interleave(h // kvh, dim=1)
    amask = mask[:, None]
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask))
    out_bytes = q.numel() * q.element_size()
    b_ms, b_by = bound(nbytes(q, k, v, qp, qp, qs, qs) + out_bytes, pairs * 4 * d, "bfloat16")
    t_lse = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, with_lse=True))
    print(f"  times (ms): kernel={t_kernel:.4f} with_lse={t_lse:.4f} plain={t_plain:.4f} "
          f"sdpa={t_lib:.4f} bound={b_ms:.4f} ({b_by})", flush=True)
    records["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:265",
        max_abs_err=main_err, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_lib,
    )

    # packed rows: padding, several documents per row, a window
    pos = ints(packed_positions(4, 512, rng))
    q2, k2, v2 = randn(4, 512, h, d), randn(4, 512, kvh, d), randn(4, 512, kvh, d)
    got, lse = fa.flash_attention(q2, k2, v2, pos, pos, causal=True, window=100, with_lse=True)
    want, wlse = fa.attention_fwd_ref(q2, k2, v2, causal=True, window=100, q_pos=pos, k_pos=pos)
    check_close("packed+padded+window=100 out", got, want, TOL_BF16_OUT)
    check_close("packed lse", lse, wlse, TOL_F32)
    dead = pos < 0
    if not (got[dead].abs().max() == 0 and bool((lse.transpose(1, 2)[dead] == fa.NEG_INF).all())):
        fail("padded query rows must give exactly 0 and lse -1e30")
    # D = 64, and a float32 case
    q3, k3, v3 = randn(4, 256, 8, 64), randn(4, 256, 2, 64), randn(4, 256, 2, 64)
    got, lse = fa.flash_attention(q3, k3, v3, causal=True, with_lse=True)
    want, wlse = fa.attention_fwd_ref(q3, k3, v3, causal=True)
    check_close("D=64 bf16 out", got, want, TOL_BF16_OUT)
    check_close("D=64 lse", lse, wlse, TOL_F32)
    pos4 = ints(packed_positions(2, 200, rng))
    q4, k4, v4 = (randn(2, 200, 4, 128, dtype=torch.float32),
                  randn(2, 200, 2, 128, dtype=torch.float32),
                  randn(2, 200, 2, 128, dtype=torch.float32))
    got = fa.flash_attention(q4, k4, v4, pos4, pos4, causal=True)
    want = fa.attention_fwd_ref(q4, k4, v4, causal=True, q_pos=pos4, k_pos=pos4)[0]
    check_close("f32 packed S=200 out", got, want, TOL_F32)

    # ---- K12 flash_decode: split + combine --------------------------------
    print("[kernels] flash_decode_split / flash_decode_combine", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for lanes in (1, 4):
        b, c = 8, 552
        qd = randn(b, lanes, h, d)
        kc, vc = randn(b, c, kvh, d), randn(b, c, kvh, d)
        qp, kp, qs, ks = (ints(a) for a in paged_cache(b, c, lanes, 368, rng))
        chunk, ns = fd.split_plan(b, kvh, (h // kvh) * lanes, c, n_sm)
        blocks = b * kvh * -(-(h // kvh) * lanes // fd.ROWS_PER_BLOCK) * ns
        print(f"  L={lanes}: chunk={chunk} splits={ns} blocks={blocks} (SMs {n_sm})", flush=True)
        if blocks < 2 * n_sm and ns < -(-c // fd.TILE):
            fail("split plan does not cover the SMs twice")
        kw = dict(causal=True, window=0)
        m, l, acc = fd.flash_decode_split(qd, kc, vc, qp, kp, qs, ks, chunk=chunk, **kw)
        wm, wl, wacc = fd.decode_split_ref(qd, kc, vc, qp, kp, qs, ks, chunk=chunk, **kw)
        live = wl > 0
        if not torch.equal(live, l > 0):
            fail("split: the kernel and the plain version disagree on empty chunks")
        e_m = check_close(f"L={lanes} split m (live chunks)", m[live], wm[live], TOL_F32)
        e_l = check_close(f"L={lanes} split l", l, wl, TOL_F32)
        e_a = check_close(f"L={lanes} split acc", acc, wacc, TOL_F32)
        out = fd.flash_decode_combine(m, l, acc, qd.dtype)
        e_c = check_close(f"L={lanes} combine out", out, fd.decode_combine_ref(m, l, acc, qd.dtype),
                          TOL_BF16_OUT)
        full = fd.flash_decode(qd, kc, vc, qp, kp, qs, ks)
        want = fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks)
        e_f = check_close(f"L={lanes} flash_decode vs decode_attention_ref", full, want,
                          TOL_BF16_OUT)
        if full[qp < 0].abs().max() != 0:
            fail("idle lanes must give exactly 0")
        if lanes != 1:
            continue
        # timings at the serving decode shape (L = 1)
        dmask = fa.attention_mask(qp, kp, qs, ks, causal=True)
        pairs = int(dmask.sum()) * h
        t_split = cuda_ms(lambda: fd.flash_decode_split(qd, kc, vc, qp, kp, qs, ks,
                                                        chunk=chunk, **kw))
        t_split_plain = cuda_ms(lambda: fd.decode_split_ref(qd, kc, vc, qp, kp, qs, ks,
                                                            chunk=chunk, **kw))
        t_comb = cuda_ms(lambda: fd.flash_decode_combine(m, l, acc, qd.dtype))
        t_comb_plain = cuda_ms(lambda: fd.decode_combine_ref(m, l, acc, qd.dtype))
        t_full = cuda_ms(lambda: fd.flash_decode(qd, kc, vc, qp, kp, qs, ks))
        t_full_plain = cuda_ms(lambda: fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks))
        qt = qd.transpose(1, 2).contiguous()
        kt = kc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        vt = vc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        amask = dmask[:, None]
        t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask))
        # K/V bytes: only the slots this run's queries attend (live slots of
        # rows with a live lane); the rest of the cache need not be read
        kv_need = int(dmask.any(dim=1).sum()) * kvh * d * kc.element_size() * 2
        print(f"  K/V the decode needs: {kv_need / 1e6:.2f} MB of the cache's "
              f"{nbytes(kc, vc) / 1e6:.2f} MB", flush=True)
        s_ms, s_by = bound(nbytes(qd, qp, kp, qs, ks, m, l, acc) + kv_need, pairs * 4 * d,
                           "bfloat16")
        c_ms, c_by = bound(nbytes(m, l, acc, out), m.numel() * (4 + 3 * d), "float32")
        f_ms, _ = bound(nbytes(qd, qp, kp, qs, ks, out) + kv_need, pairs * 4 * d, "bfloat16")
        print(f"  split (ms): kernel={t_split:.4f} plain={t_split_plain:.4f} "
              f"bound={s_ms:.4f} ({s_by})", flush=True)
        print(f"  combine (ms): kernel={t_comb:.4f} plain={t_comb_plain:.4f} "
              f"bound={c_ms:.4f} ({c_by})", flush=True)
        print(f"  flash_decode split+combine (ms): kernels={t_full:.4f} "
              f"plain decode_attention_ref={t_full_plain:.4f} sdpa={t_lib:.4f} "
              f"bound={f_ms:.4f}", flush=True)
        records["flash_decode_split"] = dict(
            name="flash_decode_split", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:43",
            max_abs_err=max(e_m, e_l, e_a), ms=t_split, plain_ms=t_split_plain,
            bound_ms=s_ms, bound_by=s_by, library_ms=None,
        )
        records["flash_decode_combine"] = dict(
            name="flash_decode_combine", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:43",
            max_abs_err=max(e_c, e_f), ms=t_comb, plain_ms=t_comb_plain,
            bound_ms=c_ms, bound_by=c_by, library_ms=None,
        )


# ---------------------------------------------------------------------------
# phases 4-6: the serving path at full width
# ---------------------------------------------------------------------------

def counters():
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

    return {"flash_attention_fwd": fa.flash_attention,
            "flash_decode_split": fd.flash_decode_split,
            "flash_decode_combine": fd.flash_decode_combine,
            "flash_attention_bwd": fab.flash_attention_bwd,
            "flat_moments_accum": fs.flat_moments_accum,
            "flat_moments_finalize": fs.flat_moments_finalize,
            "flat_g_accum": fs.flat_g_accum,
            "flat_vr_lamb": fu.flat_vr_lamb,
            "flat_vr_adam": fu.flat_vr_adam,
            "flat_vr_lars": fu.flat_vr_lars,
            "flat_vr_scale": fu.flat_vr_scale,
            "flat_pack_square": fs.flat_pack_square,
            "flat_vmap_moments": fs.flat_vmap_moments,
            "vr_scale": vu.vr_scale,
            "vr_adam_inner": va.vr_adam_inner,
            "vr_lamb_inner": vl.vr_lamb_inner,
            "vr_lars_inner": vl.vr_lars_inner,
            "moments_accum": gs.moments_accum,
            "moments_finalize": gs.moments_finalize,
            "leaf_r_partials": fsp.leaf_r_partials,
            "vr_scale_apply": fsp.vr_scale_apply,
            "vr_adam_apply": fsp.vr_adam_apply,
            "vr_lamb_compute": fsp.vr_lamb_compute,
            "vr_lars_compute": fsp.vr_lars_compute,
            "trust_apply": fsp.trust_apply}


SERVE_KERNELS = ("flash_attention_fwd", "flash_decode_split", "flash_decode_combine")


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_profile(fn):
    """(device-busy ms, kernel launches, per-kernel rows by device time) of
    one fn() call, from torch.profiler's CUDA kernel events; busy is None if
    the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return None, 0, []
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


# device-time categories of a profile, by kernel name: the port's kernels,
# cuBLAS GEMMs, and the rest (element-wise, copies, reductions)
PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "decode_split_kernel",
                "decode_combine_kernel", "accum_kernel", "finalize_kernel",
                "r_partials_kernel", "adam_kernel", "apply_kernel", "scale_kernel",
                "lars_compute_kernel", "vmap_moments_kernel", "leaf_")


def category(key: str) -> str:
    if any(k in key for k in PORT_KERNELS):
        return "port kernels"
    if "nvjet" in key or "gemm" in key.lower() or "cutlass" in key:
        return "GEMMs"
    return "other (element-wise, copies, reductions)"


def report_profile(name, fn, wall_ms, top: int = 6):
    busy, launches, rows = device_profile(fn)
    if busy is None:
        print(f"  {name}: wall {wall_ms:.2f} ms; device time not measured (no CUDA events)",
              flush=True)
        return
    print(f"  {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall_ms:.3f}), {launches} kernel launches", flush=True)
    cats = {}
    for key, ms, n in rows:
        c = cats.setdefault(category(key), [0.0, 0])
        c[0] += ms
        c[1] += n
    print("    by category: " + "; ".join(f"{c} {ms:.2f} ms x{n}" for c, (ms, n) in cats.items()),
          flush=True)
    for key, ms, n in rows[:top]:
        print(f"    {ms:8.3f} ms  x{n:<5d} {key[:90]}", flush=True)


def phase_engine(records):
    import torch

    from repro_torch.backend import Backend
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousEngine, Engine

    dev = torch.device("cuda")
    cfg = get_config("internlm2-1.8b")
    m = cfg.model
    b, s, new = 8, 512, 32
    cache_len = s + new + 8  # as launch/serve.py computes it
    t0 = time.perf_counter()
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    eng = Engine(cfg, params, cache_len=cache_len, device=dev)
    torch.cuda.synchronize()
    print(f"[engine] {m.name}: {n_params / 1e9:.3f} B params (analytic {m.param_count() / 1e9:.3f} B), "
          f"{m.n_layers} layers, d_model {m.d_model}, heads {m.n_heads}/{m.n_kv_heads}, "
          f"head_dim {m.resolved_head_dim}, vocab {m.vocab_size}; "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    if n_params != m.param_count() + m.d_model:  # the analytic count leaves out the final norm
        fail("param count differs from the config's analytic count")
    prompts = np.random.default_rng(1).integers(0, m.vocab_size, size=(b, s))

    eng.generate(prompts, 2)  # warm-up
    _, t_prefill = host_ms(lambda: eng.generate(prompts, 0))
    reset_counts()
    res, t_total = host_ms(lambda: eng.generate(prompts, new))
    counts = read_counts()
    print(f"  launches in generate(B={b}, prompt={s}, new={new}): {counts}", flush=True)
    want = {"flash_attention_fwd": m.n_layers,
            "flash_decode_split": m.n_layers * new,
            "flash_decode_combine": m.n_layers * new}
    want.update({name: 0 for name in counts if name not in SERVE_KERNELS})
    if counts != want:
        fail(f"launch counts {counts} != expected {want} (24 per prefill, 24 per decode step)")
    for name in SERVE_KERNELS:
        records[name].setdefault("launches_by_path", {})["serve"] = counts[name]
    if res.tokens.shape != (b, new) or not np.isfinite(res.logprobs).all():
        fail(f"generate returned {res.tokens.shape} tokens / non-finite logprobs")
    if not ((res.tokens >= 0) & (res.tokens < m.vocab_size)).all():
        fail("generated tokens out of vocabulary")
    decode_ms = t_total - t_prefill
    print(f"  prefill (B={b}, S={s}) {t_prefill:.1f} ms (host clock, synchronized); "
          f"decode {new} steps {decode_ms:.1f} ms = {b * new / decode_ms * 1e3:.1f} tok/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    with torch.no_grad():
        toks = torch.as_tensor(prompts, device=dev)
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        logits, cache = host_ms(lambda: eng._prefill(toks))[0]
        tok = logits[:, -1].argmax(-1)[:, None]
        _, t_pre = host_ms(lambda: eng._prefill(toks))
        report_profile("prefill (profiled)", lambda: eng._prefill(toks), t_pre)
        _, t_step = host_ms(lambda: eng._decode(cache, tok, pos))
        report_profile("decode step (profiled)", lambda: eng._decode(cache, tok, pos + 1), t_step)
        del cache

    # ---- phase 5: the same weights through the plain attention plan -------
    print("[reference] same weights, Backend(attention='reference')", flush=True)
    rcfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=Backend.all_reference()))
    reng = Engine(rcfg, params, cache_len=cache_len, device=dev)
    toks = torch.as_tensor(prompts, device=dev)
    # Tolerance: both plans run the same bf16 projections; attention differs
    # in rounding (the kernel keeps scores and p in f32, the plain path
    # rounds scores and weights to bf16), and the difference compounds over
    # 24 layers.  Measured on an H100 (700 W): prefill max |diff| 0.095, mean
    # 0.015, on logits of std ~1.  Bounds: max 0.5, mean 0.05.
    def check_logits(what, a, c):
        diff = (a - c).abs()
        print(f"  {what} logits: max |fused - reference| = {float(diff.max()):.4f}, "
              f"mean {float(diff.mean()):.5f}, logit std {float(c.std()):.3f} "
              f"(tol max 0.5, mean 0.05)", flush=True)
        if not (float(diff.max()) <= 0.5 and float(diff.mean()) <= 0.05):
            fail(f"{what} logits of the fused and reference plans disagree")
        return float(diff.max())

    rres, t_ref = host_ms(lambda: reng.generate(prompts, new))
    print(f"  reference plan generate(B={b}, prompt={s}, new={new}): {t_ref:.1f} ms "
          f"(fused plan {t_total:.1f} ms)", flush=True)
    same = int((res.tokens == rres.tokens).all(axis=1).sum())
    print(f"  greedy tokens identical on {same}/{b} rows", flush=True)
    # Teacher-forced along the fused plan's tokens: each plan's own prefill
    # and decode steps are fed the prompt and then every token the fused
    # engine emitted, so at every step both score the same context (step 0
    # is the prefill).  The logits must agree at every step (the tolerance
    # above), and the fused
    # token must be a near-top choice of the reference: its reference logit
    # within twice the measured max |fused - reference| of the reference's
    # top-1 (the most two logits can swap by under that difference).
    fused_toks = torch.as_tensor(res.tokens, device=dev).long()

    def teacher_forced(e):
        logits, cache = e._prefill(toks)
        out = [logits[:, -1]]
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        for t in range(new - 1):
            logits, cache = e._decode(cache, fused_toks[:, t:t + 1], pos)
            out.append(logits[:, -1])
            pos = pos + 1
        return torch.stack(out, 1)

    with torch.no_grad():
        reset_counts()
        tf_f = teacher_forced(eng)
        got = read_counts()
        if {k: got[k] for k in SERVE_KERNELS} != {
                "flash_attention_fwd": m.n_layers, "flash_decode_split": m.n_layers * (new - 1),
                "flash_decode_combine": m.n_layers * (new - 1)}:
            fail(f"the fused plan did not launch the kernels in every layer: {read_counts()}")
        tf_r = teacher_forced(reng)
    tf_max = check_logits(f"teacher-forced, all {new} steps,", tf_f, tf_r)
    gap_tol = 2 * tf_max
    gap = (tf_r.max(-1).values - tf_r.gather(-1, fused_toks[..., None])[..., 0]).cpu().numpy()
    top2 = torch.topk(tf_r, 2, dim=-1).values
    typical = float((top2[..., 0] - top2[..., 1]).median())
    worst = np.unravel_index(int(gap.argmax()), gap.shape)
    print(f"  reference logit of the fused token below the reference top-1: max "
          f"{float(gap.max()):.4f} (row {worst[0]}, step {worst[1]}) over {b}x{new} steps, "
          f"{int((gap > 0).sum())} steps not the reference's top-1; tol {gap_tol:.4f} = "
          f"2 x measured max |diff|; median reference top-2 gap {typical:.4f}", flush=True)
    if float(gap.max()) > gap_tol:
        fail(f"row {worst[0]} step {worst[1]}: the fused plan chose a token the reference "
             f"scores {float(gap.max()):.4f} below its top-1")
    del tf_r, tf_f
    del reng

    # ---- phase 6: continuous batching -------------------------------------
    print("[continuous] ContinuousEngine rows=2 lanes=4", flush=True)
    ce = ContinuousEngine(cfg, params, rows=2, lanes=4, device=dev)
    rng = np.random.default_rng(2)
    lens = [32, 64, 96, 128, 192, 256, 320, 384]
    news = [16, 8, 24, 12, 32, 6, 20, 10]
    rids = [ce.submit(rng.integers(0, m.vocab_size, size=n), k) for n, k in zip(lens, news)]
    reset_counts()
    steps = 0
    t0 = time.perf_counter()
    while ce.pending or ce.active:
        ce.step()
        steps += 1
        if steps > 500:
            fail("ContinuousEngine did not drain")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    for rid, k in zip(rids, news):
        r = ce.result(rid)
        if len(r.tokens) != k or not np.isfinite(r.logprobs).all():
            fail(f"request {rid}: {len(r.tokens)} tokens, expected {k}")
    print(f"  drained {len(rids)} requests ({sum(news)} tokens) in {steps} steps, "
          f"{dt:.2f}s; launches {counts}", flush=True)
    if min(counts[k] for k in SERVE_KERNELS) == 0:
        fail("ContinuousEngine did not run every kernel")


# ---------------------------------------------------------------------------
# phase 7: the training kernels at the main path's shapes
# ---------------------------------------------------------------------------

# Stated tolerances of the training kernels.  The attention backward and its
# plain version do the same f32 math from the same bf16 inputs and round
# the gradients to bf16 (dq is summed in f32 first), so an element may land
# on a neighbouring bf16 value: one ulp, at most 2^-7 of its magnitude.
# The gradients are much smaller than the forward outputs (a typical |dq| at
# bert's shape is ~0.1), so the bound scales with what is compared:
# rtol 2^-7 and atol 2^-7 * max|plain| (tol_scaled); the forward's out at
# the training shape is held to the same rule, its lse to TOL_F32.  The
# moment carry is element-wise f32: exact up to
# one FMA rounding (rtol 1e-6); the finalize multiplies by the same 1/k
# (exact).  The VR-LAMB update's per-leaf sums (of r, u^2 and w^2, up to
# 1e8 terms) are f32 atomics over 64-row partials in the kernel and a
# pairwise torch sum in the plain version: upd and f32 state rtol 1e-4 with
# atol 1e-4 of the largest magnitude; bf16 state one bf16 ulp (rtol 2^-7).
TOL_CARRY = dict(atol=0.0, rtol=1e-6)
TOL_EXACT = dict(atol=0.0, rtol=0.0)
TOL_BF16_STATE = dict(atol=1e-6, rtol=2.0**-7)


def tol_scaled(want):
    """One bf16 ulp of each element, and of the largest one near zero."""
    return dict(atol=2.0**-7 * float(want.float().abs().max()), rtol=2.0**-7)


def sdpa_bwd_ms(q, k, v, do, mask):
    """Device ms of the backward of F.scaled_dot_product_attention under
    ``mask`` (None = no mask): forward+backward minus forward."""
    import torch
    import torch.nn.functional as F

    h, kvh = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_(True)
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    am = None if mask is None else mask[:, None]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    return cuda_ms(fwd_bwd) - cuda_ms(fwd)


def train_layout(cfg):
    """The ParamLayout of ``cfg``'s reference (stacked) param tree, from
    meta tensors (no memory)."""
    import torch

    from repro_torch.core.layout import ParamLayout, stack_groups
    from repro_torch.models import init_params

    meta = init_params(cfg.model, torch.Generator().manual_seed(0), device="meta")
    return ParamLayout.for_tree(stack_groups(meta))


def check_attention_bwd(name, q, k, v, do, pos, causal):
    """K1 with the LSE (the training forward's operands), then K2, each
    against its plain version on one input; returns (K1 max err, K2 max err,
    K2 inputs, K2 outputs)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    b, s = q.shape[:2]
    qp, kp, qs, ks = fa.resolve_positions(pos, pos, s, s, device=q.device)
    qp, kp, qs, ks = (fa.as_rows(t, b, s, q.device) for t in (qp, kp, qs, ks))
    out, lse = fa.flash_attention(q, k, v, qp, kp, qs, ks, causal=causal, with_lse=True)
    want_out, want_lse = fa.attention_fwd_ref(q, k, v, causal=causal, q_pos=qp, k_pos=kp,
                                              q_seg=qs, k_seg=ks)
    err_fwd = max(check_close(f"{name} fwd out", out, want_out, tol_scaled(want_out)),
                  check_close(f"{name} fwd lse", lse, want_lse, TOL_F32))
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lse, delta, do, qp, kp, qs, ks)
    got = fab.flash_attention_bwd(*args, causal=causal)
    want = fab.attention_bwd_ref(q, k, v, lse, delta, do, causal=causal, q_pos=qp, k_pos=kp,
                                 q_seg=qs, k_seg=ks)
    err = max(check_close(f"{name} {g}", a, w, tol_scaled(w))
              for g, a, w in zip(("dq", "dk", "dv"), got, want))
    dead = qp < 0
    if dead.any() and got[0][dead].abs().max() != 0:
        fail(f"{name}: padded query rows must get dq exactly 0")
    return err_fwd, err, args, got


def phase_train_kernels(records, layout):
    import torch
    import torch.nn.functional as F

    from repro_torch.core.layout import pad_mask
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flat_stats as fs
    from repro_torch.kernels import flat_update as fu

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    # ---- K2 flash_attention_bwd --------------------------------------------
    print("[train kernels] flash_attention_bwd", flush=True)
    b, s, h, d = 32, 128, 16, 64  # bert-large, one microbatch of 32 x 128
    q, k, v, do = (randn(b, s, h, d) for _ in range(4))
    fwd_err, err_bert, args, got = check_attention_bwd(
        "bert B32 S128 H16 D64 bf16 bidirectional", q, k, v, do, None, False)
    pairs = b * h * s * s
    # K1 at this shape: the training forward and its remat (both with the LSE)
    qp, kp, qs, ks = args[6:]
    t1 = cuda_ms(lambda: fa.flash_attention(q, k, v, qp, kp, qs, ks, causal=False,
                                            with_lse=True))
    t1_plain = cuda_ms(lambda: fa.attention_fwd_ref(q, k, v, causal=False, q_pos=qp, k_pos=kp,
                                                    q_seg=qs, k_seg=ks))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t1_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    del qt, kt, vt
    b1_ms, b1_by = bound(nbytes(q, k, v, qp, kp, qs, ks, q, args[3]), pairs * 4 * d, "bfloat16")
    print(f"  K1 at bert's training shape (ms): kernel with_lse={t1:.4f} plain={t1_plain:.4f} "
          f"sdpa={t1_lib:.4f} bound={b1_ms:.4f} ({b1_by})", flush=True)
    records["flash_attention_fwd"].update(
        max_abs_err=max(records["flash_attention_fwd"]["max_abs_err"], fwd_err),
        train_shape="B32 S128 H16 D64 bf16 bidirectional with_lse", train_max_abs_err=fwd_err,
        train_ms=t1, train_plain_ms=t1_plain, train_bound_ms=b1_ms, train_bound_by=b1_by,
        train_library_ms=t1_lib)
    t_kernel = cuda_ms(lambda: fab.flash_attention_bwd(*args, causal=False))
    t_plain = cuda_ms(lambda: fab.attention_bwd_ref(
        *args[:6], causal=False, q_pos=args[6], k_pos=args[7], q_seg=args[8], k_seg=args[9]))
    t_lib = sdpa_bwd_ms(q, k, v, do, None)
    b_ms, b_by = bound(nbytes(*args, *got), pairs * 10 * d, "bfloat16")
    print(f"  bert times (ms): kernel={t_kernel:.4f} plain={t_plain:.4f} "
          f"sdpa backward={t_lib:.4f} bound={b_ms:.4f} ({b_by})", flush=True)

    b2, s2, h2, kvh2, d2 = 8, 512, 16, 8, 128  # internlm2-1.8b: GQA, causal, packed + pads
    pos = torch.from_numpy(packed_positions(b2, s2, rng)).to(dev)
    q2, do2 = randn(b2, s2, h2, d2), randn(b2, s2, h2, d2)
    k2, v2 = randn(b2, s2, kvh2, d2), randn(b2, s2, kvh2, d2)
    fwd_err2, err_intern, args2, got2 = check_attention_bwd(
        "internlm2 B8 S512 H16/8 D128 bf16 causal packed", q2, k2, v2, do2, pos, True)
    records["flash_attention_fwd"]["max_abs_err"] = max(
        records["flash_attention_fwd"]["max_abs_err"], fwd_err2)
    mask2 = fa.attention_mask(args2[6], args2[7], args2[8], args2[9], causal=True)
    t2_kernel = cuda_ms(lambda: fab.flash_attention_bwd(*args2, causal=True))
    t2_plain = cuda_ms(lambda: fab.attention_bwd_ref(
        *args2[:6], causal=True, q_pos=args2[6], k_pos=args2[7], q_seg=args2[8],
        k_seg=args2[9]))
    t2_lib = sdpa_bwd_ms(q2, k2, v2, do2, mask2)
    b2_ms, b2_by = bound(nbytes(*args2, *got2), int(mask2.sum()) * h2 * 10 * d2, "bfloat16")
    print(f"  internlm2 times (ms): kernel={t2_kernel:.4f} plain={t2_plain:.4f} "
          f"sdpa backward={t2_lib:.4f} bound={b2_ms:.4f} ({b2_by})", flush=True)

    # through the autograd Function, against autograd through the plain forward
    launches = (fa.flash_attention.launches, fab.flash_attention_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_train(*leaves, causal=False).backward(do)
    if (fa.flash_attention.launches - launches[0], fab.flash_attention_bwd.launches - launches[1]) \
            != (1, 1):
        fail("the autograd Function did not run one forward and one backward kernel")
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.attention_fwd_ref(*plain, causal=False)[0].backward(do)
    err_fn = max(check_close(f"Function d{n} vs autograd of the plain forward", a.grad, w.grad,
                             tol_scaled(w.grad)) for n, a, w in zip("qkv", leaves, plain))
    records["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:104",
        max_abs_err=max(err_bert, err_intern, err_fn), ms=t_kernel, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        internlm2_ms=t2_kernel, internlm2_plain_ms=t2_plain, internlm2_bound_ms=b2_ms,
        internlm2_library_ms=t2_lib,
    )
    del q, k, v, do, args, got, q2, k2, v2, do2, args2, got2, leaves, plain

    # ---- K3 / K4 on bert-large's full flat layout ---------------------------
    n = layout.n_rows * 128
    print(f"[train kernels] flat layout: {layout.n_leaves} leaves, {layout.n_rows} rows, "
          f"{n * 4 / 1e9:.3f} GB per f32 buffer", flush=True)
    mask = pad_mask(layout, dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def rand(scale=1.0, positive=False):
        x = torch.randn((layout.n_rows, 128), generator=gen, device=dev)
        if positive:
            x.abs_()
        return x.mul_(scale).mul_(mask)

    gs, g2s, g = rand(), rand(positive=True), rand()
    kg, kg2 = fs.flat_moments_accum(gs.clone(), g2s.clone(), g)
    pg, pg2 = fs.moments_accum_ref(gs.clone(), g2s.clone(), g)
    err3 = max(check_close("flat_moments_accum g_sum", kg, pg, TOL_CARRY),
               check_close("flat_moments_accum g2_sum", kg2, pg2, TOL_CARRY))
    t3 = cuda_ms(lambda: fs.flat_moments_accum(gs, g2s, g))
    t3_plain = cuda_ms(lambda: fs.moments_accum_ref(gs, g2s, g))
    t3_lib = cuda_ms(lambda: (gs.add_(g), g2s.addcmul_(g, g)))
    b3_ms, b3_by = bound(5 * n * 4, 3 * n, "float32")
    print(f"  flat_moments_accum (ms): kernel={t3:.4f} plain={t3_plain:.4f} "
          f"add_+addcmul_={t3_lib:.4f} bound={b3_ms:.4f} ({b3_by})", flush=True)
    km, ksq = fs.flat_moments_finalize(pg.clone(), pg2.clone(), 8)  # the same carry for both
    pm, psq = fs.moments_finalize_ref(pg, pg2, 8)
    err4 = max(check_close("flat_moments_finalize mean", km, pm, TOL_EXACT),
               check_close("flat_moments_finalize sq_mean", ksq, psq, TOL_EXACT))
    t4 = cuda_ms(lambda: fs.flat_moments_finalize(gs, g2s, 8))
    t4_plain = cuda_ms(lambda: fs.moments_finalize_ref(gs, g2s, 8))
    t4_lib = cuda_ms(lambda: (gs.mul_(0.125), g2s.mul_(0.125)))
    b4_ms, b4_by = bound(4 * n * 4, 2 * n, "float32")
    print(f"  flat_moments_finalize (ms): kernel={t4:.4f} plain={t4_plain:.4f} "
          f"2x mul_={t4_lib:.4f} bound={b4_ms:.4f} ({b4_by})", flush=True)
    records["flat_moments_accum"] = dict(
        name="flat_moments_accum", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/grad_stats.py:35", max_abs_err=err3, ms=t3,
        plain_ms=t3_plain, bound_ms=b3_ms, bound_by=b3_by, library_ms=t3_lib)
    records["flat_moments_finalize"] = dict(
        name="flat_moments_finalize", route="cuda",
        source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/grad_stats.py:41", max_abs_err=err4, ms=t4,
        plain_ms=t4_plain, bound_ms=b4_ms, bound_by=b4_by, library_ms=t4_lib)
    del gs, g2s, g, kg, kg2, pg, pg2, km, ksq, pm, psq

    # ---- K5 flat_vr_lamb and K6 flat_vr_adam ---------------------------------
    print("[train kernels] flat_vr_lamb, flat_vr_adam", flush=True)
    g = rand(1e-3)
    g2 = (g * g).add_(rand(1e-6, positive=True))
    ga, w = g * 0.5, rand(0.03)
    m0, v0 = rand(1e-4), rand(1e-7, positive=True)
    p0 = mask.float().mul_(0.4)
    meta_bytes = 4 * layout.n_blocks + 4 * layout.leaf_slots
    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
    scal = (3.5e-6, 0.19, 0.001999, 0.19)
    adam_family = {"flat_vr_lamb": (fu.flat_vr_lamb, fu.flat_vr_lamb_ref, "304", 3),
                   "flat_vr_adam": (fu.flat_vr_adam, fu.flat_vr_adam_ref, "217", 2)}
    for name, (kernel, plain, line, n_launch) in adam_family.items():
        err, times = 0.0, {}
        for sd_name in ("float32", "bfloat16"):
            sd = getattr(torch, sd_name)
            km, kv, kp = (t.to(sd) for t in (m0, v0, p0))
            pm, pv, pp = (t.clone() for t in (km, kv, kp))
            upd = kernel(g, ga, g2, km, kv, kp, w, scal, layout, state_dtype=sd_name, **hyper)[0]
            want = plain(g, ga, g2, pm, pv, pp, w, scal, layout, state_dtype=sd_name, **hyper)[0]
            tol_upd = dict(atol=1e-4 * float(want.abs().max()), rtol=1e-4)
            err = max(err, check_close(f"{name} {sd_name} state: upd", upd, want, tol_upd))
            del upd, want
            for nm, a, b_ in zip(("m", "v", "p"), (km, kv, kp), (pm, pv, pp)):
                tol = TOL_BF16_STATE if sd_name == "bfloat16" else \
                    dict(atol=1e-4 * float(b_.abs().max()), rtol=1e-4)
                err = max(err, check_close(f"{name} {sd_name} state: {nm}'", a, b_, tol))
            del pm, pv, pp
            t_k = cuda_ms(lambda: kernel(g, ga, g2, km, kv, kp, w, scal, layout,
                                         state_dtype=sd_name, **hyper))
            t_p = cuda_ms(lambda: plain(g, ga, g2, km, kv, kp, w, scal, layout,
                                        state_dtype=sd_name, **hyper), iters=5)
            state_bytes = 6 * n * km.element_size()
            b_ms, b_by = bound(5 * n * 4 + state_bytes + meta_bytes, 40 * n, "float32")
            times[sd_name] = (t_k, t_p, b_ms, b_by)
            print(f"  {name} {sd_name} state (ms): kernel ({n_launch} launches)={t_k:.4f} "
                  f"plain={t_p:.4f} bound={b_ms:.4f} ({b_by}); no single PyTorch call "
                  "computes it", flush=True)
            del km, kv, kp
        t_k, t_p, b_ms, b_by = times["float32"]
        records[name] = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/flat_update.cu",
            replaces=f"src/repro/kernels/flat_update.py:{line}", max_abs_err=err, ms=t_k,
            plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bf16_state_ms=times["bfloat16"][0], bf16_state_plain_ms=times["bfloat16"][1],
            bf16_state_bound_ms=times["bfloat16"][2],
        )
    torch.cuda.empty_cache()

    # ---- K7 flat_vr_lars ----------------------------------------------------
    print("[train kernels] flat_vr_lars", flush=True)
    lars = dict(mu=0.9, wd=0.01, trust=0.001, eps=1e-12)
    lscal = (3.5e-3, 0.1)
    km, pm = m0.clone(), m0.clone()
    upd = fu.flat_vr_lars(g, ga, g2, km, w, lscal, layout, **lars)[0]
    want = fu.flat_vr_lars_ref(g, ga, g2, pm, w, lscal, layout, **lars)[0]
    err7 = max(check_close("flat_vr_lars upd", upd, want,
                           dict(atol=1e-4 * float(want.abs().max()), rtol=1e-4)),
               check_close("flat_vr_lars m'", km, pm,
                           dict(atol=1e-4 * float(pm.abs().max()), rtol=1e-4)))
    del upd, want, pm
    t7 = cuda_ms(lambda: fu.flat_vr_lars(g, ga, g2, km, w, lscal, layout, **lars))
    t7_plain = cuda_ms(lambda: fu.flat_vr_lars_ref(g, ga, g2, km, w, lscal, layout, **lars),
                       iters=5)
    b7_ms, b7_by = bound(7 * n * 4 + meta_bytes, 20 * n, "float32")
    print(f"  flat_vr_lars (ms): kernel (3 launches)={t7:.4f} plain={t7_plain:.4f} "
          f"bound={b7_ms:.4f} ({b7_by}); no single PyTorch call computes it", flush=True)
    records["flat_vr_lars"] = dict(
        name="flat_vr_lars", route="cuda", source="src/repro_torch/kernels/csrc/flat_update.cu",
        replaces="src/repro/kernels/flat_update.py:393", max_abs_err=err7, ms=t7,
        plain_ms=t7_plain, bound_ms=b7_ms, bound_by=b7_by, library_ms=None)
    del km

    # ---- K8 flat_vr_scale ---------------------------------------------------
    print("[train kernels] flat_vr_scale", flush=True)
    sg, r = fu.flat_vr_scale(g, ga, g2, layout, gamma=0.1, eps=1e-12)
    wsg, wr = fu.flat_vr_scale_ref(g, ga, g2, layout, gamma=0.1, eps=1e-12)
    err8 = max(check_close("flat_vr_scale sg", sg, wsg,
                           dict(atol=1e-4 * float(wsg.abs().max()), rtol=1e-4)),
               check_close("flat_vr_scale r", r, wr, dict(atol=1e-4, rtol=1e-4)))
    if not (bool((r[~mask] == 0.1).all()) and bool((sg[~mask] == 0).all())):
        fail("flat_vr_scale: the padded tail must hold r = gamma and sg = 0")
    del sg, r, wsg, wr
    t8 = cuda_ms(lambda: fu.flat_vr_scale(g, ga, g2, layout, gamma=0.1, eps=1e-12))
    t8_plain = cuda_ms(lambda: fu.flat_vr_scale_ref(g, ga, g2, layout, gamma=0.1, eps=1e-12),
                       iters=5)
    b8_ms, b8_by = bound(5 * n * 4 + meta_bytes, 10 * n, "float32")
    print(f"  flat_vr_scale (ms): kernel (2 launches)={t8:.4f} plain={t8_plain:.4f} "
          f"bound={b8_ms:.4f} ({b8_by}); no single PyTorch call computes it", flush=True)
    records["flat_vr_scale"] = dict(
        name="flat_vr_scale", route="cuda", source="src/repro_torch/kernels/csrc/flat_update.cu",
        replaces="src/repro/kernels/flat_update.py:153", max_abs_err=err8, ms=t8,
        plain_ms=t8_plain, bound_ms=b8_ms, bound_by=b8_by, library_ms=None)
    torch.cuda.empty_cache()

    # ---- K9 flat_g_accum ----------------------------------------------------
    print("[train kernels] flat_g_accum", flush=True)
    gs = rand()
    err9 = check_close("flat_g_accum g_sum", fs.flat_g_accum(gs.clone(), g),
                       fs.g_accum_ref(gs.clone(), g), TOL_EXACT)
    t9 = cuda_ms(lambda: fs.flat_g_accum(gs, g))
    t9_plain = cuda_ms(lambda: fs.g_accum_ref(gs, g))
    t9_lib = cuda_ms(lambda: gs.add_(g))
    b9_ms, b9_by = bound(3 * n * 4, n, "float32")
    print(f"  flat_g_accum (ms): kernel={t9:.4f} plain={t9_plain:.4f} add_={t9_lib:.4f} "
          f"bound={b9_ms:.4f} ({b9_by})", flush=True)
    records["flat_g_accum"] = dict(
        name="flat_g_accum", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/flat_stats.py:77", max_abs_err=err9, ms=t9,
        plain_ms=t9_plain, bound_ms=b9_ms, bound_by=b9_by, library_ms=t9_lib)
    del gs
    del g, g2, ga, w, m0, v0, p0
    torch.cuda.empty_cache()

    # ---- K10 flat_vmap_moments: the (k, n_rows, 128) stack of the vmap path --
    print("[train kernels] flat_vmap_moments", flush=True)
    err10, t10 = 0.0, {}
    for k in (8, 7):  # the main path's k, and an odd k
        gstack = torch.randn((k, layout.n_rows, 128), generator=gen, device=dev).mul_(mask)
        mean, sq = fs.flat_vmap_moments(gstack, k)
        want_m, want_sq = fs.vmap_moments_ref(gstack, k)
        err10 = max(err10, check_close(f"flat_vmap_moments k={k} mean", mean, want_m, TOL_EXACT),
                    check_close(f"flat_vmap_moments k={k} sq_mean", sq, want_sq, TOL_CARRY))
        if mean[~mask].any() or sq[~mask].any():
            fail("flat_vmap_moments: the padded tail must stay zero")
        del mean, sq, want_m, want_sq
        if k == 8:
            t10["ms"] = cuda_ms(lambda: fs.flat_vmap_moments(gstack, k))
            t10["plain"] = cuda_ms(lambda: fs.vmap_moments_ref(gstack, k), iters=5)
            t10["lib"] = cuda_ms(lambda: (gstack.mean(0), gstack.square().mean(0)), iters=5)
            t10["bound"] = bound((k + 2) * n * 4, 3 * k * n, "float32")
        del gstack
        torch.cuda.empty_cache()
    b10_ms, b10_by = t10["bound"]
    print(f"  flat_vmap_moments k=8 (ms): kernel={t10['ms']:.4f} plain={t10['plain']:.4f} "
          f"mean(0)+square().mean(0)={t10['lib']:.4f} bound={b10_ms:.4f} ({b10_by})", flush=True)
    records["flat_vmap_moments"] = dict(
        name="flat_vmap_moments", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/flat_stats.py:144", max_abs_err=err10, ms=t10["ms"],
        plain_ms=t10["plain"], bound_ms=b10_ms, bound_by=b10_by, library_ms=t10["lib"])
    del mask
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the training main path at full width
# ---------------------------------------------------------------------------

# Fused plan against the reference plan at full width in bf16 compute.  The
# plans differ where attention rounds: the kernels keep scores and p in f32,
# the plain path computes scores and p @ V in bf16; the difference compounds
# over 24 layers, the backward and k = 8 microbatches.  The GSNR ratio
# r = g^2 / (g2 - g^2 + eps) amplifies it where a variance nearly cancels,
# so p (a running mean of r) differs most.
# Bounds, set from the first full-width run on an H100 (700 W), which
# measured loss 3.8e-6, grad_norm 1.3e-4, gsnr/* 2.7e-4 (all relative or
# absolute as printed), and after step 1 the update 2.1e-2, m and v 1.3e-2
# and p 4.8e-2 relative to their norms (PERF.md): three to thirty times
# those.  On the CPU rehearsal at smoke size, a copy whose update dropped
# the trust ratio moved the second step's loss by 2.1e-2 relative.  Phase 9
# holds VR-Adam, VR-LARS and the stale steps to the same bounds.  The update
# compared is the change of the f32 params over the step.  VR-SGD's and
# VR-Momentum's first update, -lr * r * ga at warm-up step 0 (lr 3.5e-6), is
# ~1e-10 per element, below half an ulp of most weights (1.9e-9 at |w| ~
# 0.02), so that change is rounding quanta, and which elements round up
# flips between the plans with the update's last bits: the first full-width
# run on an H100 (700 W) measured 0.107 there, while VR-Momentum's m, which
# is r * ga itself, differs by 1.3e-2.  Their update gets a bound of its
# own, "upd_rounded" = 0.25, 2.3 times that; on the CPU rehearsal at smoke
# size, a copy whose VR scale dropped r moved VR-SGD's update by 0.495,
# twice the bound.
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 2e-3, "gsnr": 3e-3, "mv": 0.05, "p": 0.15, "upd": 0.1,
             "upd_rounded": 0.25}
# Phase 10b's data-parallel run against the single-card fused k = W run.
# Both run the same kernels at the same precision, so they differ only
# where a sum is taken in another order (a leaf split over two shards, the
# all-reduce of the payload): TRAIN_TOL, set for the bf16 fused-vs-reference
# comparison, is 100 to 10,000 times these gaps and passes a fault of the
# sharding's plumbing.  The largest gaps of three full-width runs on an H100
# 80GB HBM3 (700 W), over both groups: loss 1.05e-5, grad_norm 2.67e-4,
# gsnr/* 1.70e-4; after step 1 the update 5.35e-4 (VR-LARS; VR-SGD 1.06e-4,
# so VR-SGD needs no bound of its own here), m and v 4.29e-4, p 1.86e-5.
# Each bound is about ten times its largest gap.  Planted faults at two
# ranks on the same card: with the norm partials not all-reduced the update
# moved by 2.6e-2 (VR-LAMB) and 8.0e-2 (VR-LARS), inside TRAIN_TOL; with
# the per-leaf sum of r not all-reduced, VR-LAMB's update moved by 6.8e-3
# and its m, v, p by 0.15-0.24 (PERF.md).
DP_TOL = {"loss": 1e-4, "grad_norm": 2e-3, "gsnr": 2e-3, "mv": 5e-3, "p": 2e-4, "upd": 5e-3}
TRAIN_STEPS = 3


def rel_diff(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm((a.float() - b.float())) /
                 torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


def flat_state(state, name):
    """Optimizer state ``name`` as a new flat f32 buffer (packing a tree)."""
    import torch

    from repro_torch.core.layout import is_flat

    x = state.opt_state[name]
    if is_flat(x):
        return x.data.to(torch.float32, copy=True)
    return state.params.layout.pack(x, device=state.params.device)


def run_plan(plan, state, step, batches, want_fused, label, fresh=None):
    """Steps ``state`` through ``batches`` on one plan, the counts set to 0
    before and read after each step and held against ``want_fused(i)`` on
    the fused plan (0 everywhere on the reference plan).  Returns (state,
    metrics per step, the first step's update and flat state buffers, step
    walls, launches summed over the fused steps).  ``fresh[i]`` False makes
    step i stale."""
    import torch

    hist, walls, path_counts, step1 = [], [], {}, {}
    for i, batch in enumerate(batches):
        with_stats = True if fresh is None else fresh[i]
        w0 = state.params.data.clone() if i == 0 else None
        reset_counts()
        (state, metrics), ms = host_ms(lambda: step(state, batch, with_stats))
        counts = read_counts()
        want = want_fused(i) if plan == "fused" else {n_: 0 for n_ in counts}
        if counts != want:
            fail(f"{label} {plan} step {i}: kernel launches {counts} != expected {want}")
        if plan == "fused":
            for name, c in counts.items():
                path_counts[name] = path_counts.get(name, 0) + c
        walls.append(ms)
        vals = {key: float(val) for key, val in metrics.items()}
        if not all(np.isfinite(list(vals.values()))):
            fail(f"{label} {plan} step {i}: non-finite metrics {vals}")
        hist.append(vals)
        gsnr = (f" gsnr mean {vals['gsnr/mean']:.5f} min {vals['gsnr/min']:.4f} frac_floor "
                f"{vals['gsnr/frac_floor']:.5f}" if "gsnr/mean" in vals else " (no GSNR)")
        print(f"  {label} {plan} step {i}{'' if with_stats else ' (stale)'}: {ms:.1f} ms  "
              f"loss {vals['loss']:.5f} |g| {vals['grad_norm']:.4f} "
              f"|upd| {vals['update_norm']:.4e}{gsnr}; launches "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        if i == 0:
            step1 = {"upd": state.params.data - w0,
                     **{nm: flat_state(state, nm) for nm in "mvp" if nm in state.opt_state}}
            del w0
    return state, hist, step1, walls, path_counts


def compare_plans(label, hist, step1, when="after step 1", tol_keys=None,
                  pair=("fused", "reference"), tol=None):
    """Run ``pair[0]`` against run ``pair[1]`` (the fused plan against the
    reference plan unless said otherwise) within ``tol`` (TRAIN_TOL unless
    said otherwise): loss, grad_norm and gsnr/* (where logged) at every
    step, the update and each state buffer in ``step1`` (taken after step 1
    unless ``when`` says otherwise), each under the key ``tol_keys`` maps it
    to."""
    tol = TRAIN_TOL if tol is None else tol
    x, y = pair
    for i, (a, b_) in enumerate(zip(hist[x], hist[y])):
        d_loss = abs(a["loss"] - b_["loss"]) / abs(b_["loss"])
        d_gn = abs(a["grad_norm"] - b_["grad_norm"]) / abs(b_["grad_norm"])
        keys = [k for k in ("gsnr/mean", "gsnr/min", "gsnr/frac_floor") if k in b_]
        d_gsnr = max((abs(a[key] - b_[key]) for key in keys), default=0.0)
        print(f"  {label} step {i}: |loss rel diff| {d_loss:.3e} (tol {tol['loss']}), "
              f"|grad_norm rel diff| {d_gn:.3e} (tol {tol['grad_norm']}), "
              f"max |gsnr/* diff| {d_gsnr:.3e} (tol {tol['gsnr']})", flush=True)
        if d_loss > tol["loss"] or d_gn > tol["grad_norm"] \
                or d_gsnr > tol["gsnr"]:
            fail(f"{label} step {i}: the {x} and {y} runs disagree")
    for nm in step1[y]:
        tol_key = (tol_keys or {"m": "mv", "v": "mv"}).get(nm, nm)
        d = rel_diff(step1[x][nm], step1[y][nm])
        print(f"  {label} {when}: ||{nm}_{x} - {nm}_{y}|| / ||{nm}_{y}|| = {d:.4e} "
              f"(tol {tol[tol_key]})", flush=True)
        if not d <= tol[tol_key]:
            fail(f"{label}: {when}, {nm} of the {x} and {y} runs disagree")


def add_path(records, path, path_counts):
    for name, c in path_counts.items():
        if c:
            by_path = records[name].setdefault("launches_by_path", {})
            by_path[path] = by_path.get(path, 0) + c


def bert_train_config():
    from repro_torch.configs import get_config

    return get_config("bert-large").replace(global_batch=256, seq_len=128)


def plan_config(cfg, plan, **opt):
    from repro_torch.backend import Backend

    bk = Backend.all_fused() if plan == "fused" else Backend.all_reference()
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=bk),
                       optimizer=dataclasses.replace(cfg.optimizer, **opt))


def fused_counts(n_layers, k, update=None, carry="moments", backward_passes=None):
    """Launches of one fused step: K1 twice and K2 once per layer per
    backward pass (k microbatches, or one whole-batch pass), the carry's
    kernels and one call of the update's kernel; every other count 0."""
    passes = k if backward_passes is None else backward_passes
    want = {name: 0 for name in counters()}
    want.update(flash_attention_fwd=2 * n_layers * passes, flash_attention_bwd=n_layers * passes)
    if carry == "moments":
        want.update(flat_moments_accum=k, flat_moments_finalize=1)
    elif carry == "g":
        want.update(flat_g_accum=k)
    if update:
        want[update] = 1
    return want


def phase_train(records):
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step

    dev = torch.device("cuda")
    cfg = bert_train_config()
    m, o = cfg.model, cfg.optimizer
    print(f"[train] {m.name}: {m.n_layers} layers, d_model {m.d_model}, heads {m.n_heads}, "
          f"d_ff {m.d_ff}, vocab {m.vocab_size}; VR-LAMB k={o.k}, global batch "
          f"{cfg.global_batch} (the paper's 64k cut to 256), seq {cfg.seq_len}, "
          f"{cfg.parallel.compute_dtype} compute, {cfg.parallel.param_dtype} params and "
          f"{o.state_dtype} state, remat={cfg.parallel.remat}", flush=True)
    t0 = time.perf_counter()
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)
    plans = {}
    for plan in ("fused", "reference"):
        pc = plan_config(cfg, plan)
        plans[plan] = (init_state(pc, params=params, device=dev),
                       make_train_step(pc, log_gsnr=True, device=dev)[0])
    del params
    layout = plans["fused"][0].params.layout
    n_params = sum(layout.sizes)
    print(f"  {n_params / 1e6:.1f} M params in {layout.n_leaves} stacked leaves, "
          f"{layout.n_rows} flat rows; init {time.perf_counter() - t0:.1f}s", flush=True)
    # the analytic count leaves out the final norm and the LayerNorm biases
    norms = 2 * m.d_model + 2 * m.n_layers * m.d_model
    if n_params != m.param_count() + norms:
        fail(f"param count {n_params} != the config's {m.param_count()} + {norms} norm params")
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len, seed=0)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 1)]

    want = fused_counts(m.n_layers, o.k, "flat_vr_lamb")
    hist, step1, walls = {}, {}, None
    for plan in ("fused", "reference"):
        state, step = plans[plan]
        state, hist[plan], step1[plan], plan_walls, path_counts = run_plan(
            plan, state, step, batches[:TRAIN_STEPS], lambda i: want, "vr_lamb")
        if plan == "fused":
            walls = plan_walls
            add_path(records, "train", path_counts)
        plans[plan] = (state, step)
    compare_plans("vr_lamb", hist, step1)
    scan = {"hist": hist["fused"], "step1": step1["fused"], "walls": walls,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del step1

    # step time, tokens/s and the device's share of it (one more fused step)
    state, step = plans["fused"]
    del plans["reference"]
    torch.cuda.empty_cache()
    warm = walls[1:]
    tokens = cfg.global_batch * cfg.seq_len
    step_ms = float(np.mean(warm))
    print(f"  fused step wall (host clock, synchronized): {', '.join(f'{w:.1f}' for w in walls)} "
          f"ms; warm mean {step_ms:.1f} ms = {tokens / step_ms * 1e3:.0f} tokens/s; peak memory "
          f"{scan['peak_gib']:.1f} GiB", flush=True)
    _, t_prof = host_ms(lambda: step(state, batches[TRAIN_STEPS]))
    report_profile("fused train step (profiled)", lambda: step(state, batches[TRAIN_STEPS]),
                   t_prof, top=14)
    del state, plans
    torch.cuda.empty_cache()
    return scan


# ---------------------------------------------------------------------------
# phase 11: the vmap stats path at full width
# ---------------------------------------------------------------------------

# functorch's warning for an op without a batching rule, which it then runs
# as a loop over the vmapped groups: an error in phase 11
VMAP_FALLBACK = "There is a performance drop"
# The vmap step against phase 8's fused scan step, from the same params and
# batches on the same kernels.  Attention is row-wise, so folding the k
# groups into its batch changes nothing; the bf16 GEMMs see 8x the rows and
# cuBLAS picks other tiles, whose rounding compounds over 24 layers and the
# backward.  Bounds, set from the first full-width run on an H100 (700 W),
# which measured loss 6.1e-6, grad_norm 1.1e-4, gsnr/* 1.3e-5 and after step
# 1 the update 1.41e-2, m and v 8.1e-3, p 1.61e-2 (PERF.md): three to ten
# times those.  Planted faults in K10 that break them: PERF.md.
VMAP_TOL = {"loss": 5e-5, "grad_norm": 1e-3, "gsnr": 1e-4, "mv": 3e-2, "p": 5e-2, "upd": 5e-2}


def vmap_counts(n_layers, fresh, update="flat_vr_lamb"):
    """Launches of one fused vmap step: K1 twice and K2 once per layer for
    all k groups together, then K10 and the update's kernel on a fresh step
    (a stale step takes the stack's mean, a plain op, and its update is
    plain)."""
    want = fused_counts(n_layers, 1, update if fresh else None, carry=None)
    if fresh:
        want["flat_vmap_moments"] = 1
    return want


def phase_train_vmap(records, scan):
    """11: bert-large at phase 8's cut with stats_method="vmap": three fresh
    VR-LAMB steps and a stale one on the fused plan (launch counts asserted
    per step, functorch's fallback an error) against the same steps on the
    reference plan (TRAIN_TOL) and, for the fresh steps, against phase 8's
    fused scan steps (VMAP_TOL); warm step wall, tokens/s, peak memory and a
    profile of one more fused step beside phase 8's.  Then two fresh VR-Adam
    vmap steps (K6) on each plan, compared within TRAIN_TOL."""
    import warnings

    import torch

    from repro_torch.data import lm_batches
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step

    dev = torch.device("cuda")
    cfg = bert_train_config()
    m, k = cfg.model, cfg.optimizer.k
    tokens = cfg.global_batch * cfg.seq_len
    print(f"[train vmap] {m.name} at full width, global batch {cfg.global_batch}, seq "
          f"{cfg.seq_len}, k={k}, stats_method=vmap: one vmapped forward and backward over the "
          f"k groups; three fresh VR-LAMB steps and a stale one per plan", flush=True)
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len, seed=0)
    batches = [next(stream) for _ in range(TRAIN_STEPS + 2)]  # phase 8's, then one more
    fresh = (True,) * TRAIN_STEPS + (False,)
    hist, step1, walls, peak = {}, {}, None, None
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=VMAP_FALLBACK)
        for plan in ("fused", "reference"):
            pc = plan_config(cfg, plan, stats_method="vmap")
            state = init_state(pc, params=params, device=dev)
            step = make_train_step(pc, log_gsnr=True, device=dev)[0]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, hist[plan], step1[plan], plan_walls, path_counts = run_plan(
                plan, state, step, batches[:TRAIN_STEPS + 1],
                lambda i: vmap_counts(m.n_layers, fresh[i]), "vr_lamb vmap", fresh)
            if plan == "fused":
                walls, peak = plan_walls, torch.cuda.max_memory_allocated() / 2**30
                add_path(records, "train_vmap", path_counts)
                _, t_prof = host_ms(lambda: step(state, batches[-1]))
                report_profile("fused vmap train step (profiled)",
                               lambda: step(state, batches[-1]), t_prof, top=14)
            del state, step
            torch.cuda.empty_cache()
        adam_hist, adam_step1, adam_walls = {}, {}, None
        for plan in ("fused", "reference"):
            pc = plan_config(cfg, plan, name="vr_adam", stats_method="vmap")
            state = init_state(pc, params=params, device=dev)
            step = make_train_step(pc, log_gsnr=True, device=dev)[0]
            state, adam_hist[plan], adam_step1[plan], plan_walls, path_counts = run_plan(
                plan, state, step, batches[:2],
                lambda i: vmap_counts(m.n_layers, True, "flat_vr_adam"), "vr_adam vmap")
            if plan == "fused":
                adam_walls = plan_walls
                add_path(records, "train_vmap", path_counts)
            del state, step
            torch.cuda.empty_cache()
    del params
    compare_plans("vr_adam vmap", adam_hist, adam_step1)
    print(f"  vr_adam fused vmap step wall (host clock, synchronized): "
          f"{', '.join(f'{w:.1f}' for w in adam_walls)} ms; warm {adam_walls[-1]:.1f} ms = "
          f"{tokens / adam_walls[-1] * 1e3:.0f} tokens/s", flush=True)
    del adam_step1
    compare_plans("vr_lamb vmap", hist, step1)
    compare_plans("vr_lamb vmap vs scan", {"vmap": hist["fused"][:TRAIN_STEPS],
                                           "scan": scan["hist"]},
                  {"vmap": step1["fused"], "scan": scan["step1"]}, pair=("vmap", "scan"),
                  tol=VMAP_TOL)
    warm, scan_warm = float(np.mean(walls[1:TRAIN_STEPS])), float(np.mean(scan["walls"][1:]))
    print(f"  fused vmap step wall (host clock, synchronized): "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (the last stale); warm fresh mean "
          f"{warm:.1f} ms = {tokens / warm * 1e3:.0f} tokens/s, stale {walls[-1]:.1f} ms; peak "
          f"memory {peak:.1f} GiB.  Phase 8's scan step in this run: warm mean {scan_warm:.1f} "
          f"ms = {tokens / scan_warm * 1e3:.0f} tokens/s, peak memory {scan['peak_gib']:.1f} GiB",
          flush=True)
    del step1
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the rest of the optimizer family and the stale-GSNR step
# ---------------------------------------------------------------------------

# the kernel each VR optimizer's fused fresh step calls once
UPDATE_KERNEL = {"vr_adam": "flat_vr_adam", "vr_lars": "flat_vr_lars",
                 "vr_sgd": "flat_vr_scale", "vr_momentum": "flat_vr_scale",
                 "vr_lamb": "flat_vr_lamb"}


def phase_train_optimizers(records):
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step, train_loop

    dev = torch.device("cuda")
    cfg = bert_train_config()
    m, k = cfg.model, cfg.optimizer.k
    tokens = cfg.global_batch * cfg.seq_len
    print(f"[train optimizers] {m.name} at full width, global batch {cfg.global_batch}, seq "
          f"{cfg.seq_len}, k={k}: fresh VR-Adam/LARS/SGD/Momentum steps, stale VR-Adam/LAMB "
          "steps and a LAMB baseline step, each fused against the reference plan", flush=True)
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len, seed=1)
    batches = [next(stream) for _ in range(2)]
    path_counts = {}

    def both_plans(name, fresh=None, use_loop=False, **opt):
        """Two steps of ``name`` from the same params on each plan; with
        ``use_loop`` the reference plan runs them through train_loop, and
        the update and state compared are those after both steps."""
        hist, step1, walls = {}, {}, None
        for plan in ("fused", "reference"):
            pc = plan_config(cfg, plan, name=name, **opt)
            state = init_state(pc, params=params, device=dev)
            w_init = state.params.data.clone() if use_loop else None
            if use_loop and plan == "reference":
                reset_counts()
                state, loop_hist = train_loop(pc, iter(batches), 2, state=state, log_every=1,
                                              log_gsnr=True, device=dev)
                if any(read_counts().values()):
                    fail(f"{name} reference train_loop launched {read_counts()}")
                hist[plan] = [{kk: v for kk, v in h.items() if kk not in ("step", "wall")}
                              for h in loop_hist]
            else:
                step = make_train_step(pc, log_gsnr=True, device=dev)[0]
                stale = fused_counts(m.n_layers, k, carry="g")
                want = lambda i: fused_counts(m.n_layers, k, UPDATE_KERNEL[name]) \
                    if fresh is None or fresh[i] else stale
                state, hist[plan], step1[plan], plan_walls, counts = run_plan(
                    plan, state, step, batches, want, name, fresh)
                del step
                if plan == "fused":
                    walls = plan_walls
                    for nm, c in counts.items():
                        path_counts[nm] = path_counts.get(nm, 0) + c
            if use_loop:
                step1[plan] = {"upd": state.params.data - w_init,
                               **{nm: flat_state(state, nm) for nm in "mvp"
                                  if nm in state.opt_state}}
            del state, w_init
            torch.cuda.empty_cache()
        return hist, step1, walls

    # 1. fresh steps of each VR optimizer
    for name in ("vr_adam", "vr_lars", "vr_sgd", "vr_momentum"):
        hist, step1, walls = both_plans(name)
        rounded = name in ("vr_sgd", "vr_momentum")  # an update below the weights' ulp
        compare_plans(name, hist, step1,
                      tol_keys={"upd": "upd_rounded", "m": "mv"} if rounded else None)
        print(f"  {name} fused step wall (host clock, synchronized): "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms; warm {walls[-1]:.1f} ms = "
              f"{tokens / walls[-1] * 1e3:.0f} tokens/s", flush=True)

    # 2. a fresh then a stale step (gsnr_refresh 2): the fused plan step by
    #    step, the reference plan through train_loop; the update compared is
    #    the sum over both steps, the state the one after the stale step
    for name in ("vr_adam", "vr_lamb"):
        hist, step1, walls = both_plans(name, fresh=(True, False), use_loop=True,
                                        gsnr_refresh=2)
        if any("gsnr/mean" in h for h in (hist["fused"][1], hist["reference"][1])):
            fail(f"{name}: the stale step logged GSNR statistics")
        compare_plans(f"{name} fresh+stale", hist, step1, when="after the stale step 2")
        print(f"  {name} stale step wall (host clock, synchronized): {walls[1]:.1f} ms = "
              f"{tokens / walls[1] * 1e3:.0f} tokens/s (fresh {walls[0]:.1f} ms)", flush=True)

    # 3. a baseline: one LAMB step, a single backward over the whole batch
    pc = plan_config(cfg, "fused", name="lamb")
    state = init_state(pc, params=params, device=dev)
    del params
    step = make_train_step(pc, device=dev)[0]
    want = fused_counts(m.n_layers, k, carry=None, backward_passes=1)
    torch.cuda.reset_peak_memory_stats()
    state, hist, _, walls, counts = run_plan("fused", state, step, batches[:1],
                                             lambda i: want, "lamb (grad_only)")
    for nm, c in counts.items():
        path_counts[nm] = path_counts.get(nm, 0) + c
    print(f"  lamb baseline step wall (host clock, synchronized): {walls[0]:.1f} ms (cold) = "
          f"{tokens / walls[0] * 1e3:.0f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del state, step
    torch.cuda.empty_cache()
    add_path(records, "train_optimizers", path_counts)


# ---------------------------------------------------------------------------
# phase 10: data-parallel training (device-wise GSNR, row-sharded update)
# ---------------------------------------------------------------------------

# the data-parallel kernels and the update kernel each VR optimizer's sharded
# step calls once (K13 and, for LAMB and LARS, the trust epilogue besides)
DP_UPDATE = {"vr_lamb": "vr_lamb_compute", "vr_adam": "vr_adam_apply",
             "vr_lars": "vr_lars_compute", "vr_sgd": "vr_scale_apply"}
SPMD_SHARDS = 4


def phase_spmd_kernels(records, layout):
    """10a: K11 on bert-large's full flat layout; K13-K17 and the trust
    epilogue on that layout split into SPMD_SHARDS row shards in this
    process (the last one padded, leaves straddling the edges), the per-leaf
    partials added in rank order in place of the all-reduce; each against its
    plain version and, put together, against the single-card K5-K8."""
    import torch

    from repro_torch.core.layout import RowShard, pad_mask
    from repro_torch.kernels import flat_spmd as fsp
    from repro_torch.kernels import flat_stats as fs
    from repro_torch.kernels import flat_update as fu

    dev = torch.device("cuda")
    n = layout.n_rows * 128
    mask = pad_mask(layout, dev)
    gen = torch.Generator(device=dev).manual_seed(12)

    def rand(scale=1.0, positive=False):
        x = torch.randn((layout.n_rows, 128), generator=gen, device=dev)
        if positive:
            x.abs_()
        return x.mul_(scale).mul_(mask)

    # ---- K11 flat_pack_square ------------------------------------------------
    print("[spmd kernels] flat_pack_square on the full layout", flush=True)
    g = rand(1e-3)
    err11 = check_close("flat_pack_square [g; g^2]", fs.flat_pack_square(g),
                        fs.pack_square_ref(g), TOL_EXACT)
    t11 = cuda_ms(lambda: fs.flat_pack_square(g))
    t11_plain = cuda_ms(lambda: fs.pack_square_ref(g))
    t11_lib = cuda_ms(lambda: torch.stack((g, g * g)))
    b11_ms, b11_by = bound(3 * n * 4, n, "float32")
    print(f"  flat_pack_square (ms): kernel={t11:.4f} plain={t11_plain:.4f} "
          f"torch.stack((g, g * g)) (two operations)={t11_lib:.4f} bound={b11_ms:.4f} "
          f"({b11_by})", flush=True)
    records["flat_pack_square"] = dict(
        name="flat_pack_square", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/flat_stats.py:116", max_abs_err=err11, ms=t11,
        plain_ms=t11_plain, bound_ms=b11_ms, bound_by=b11_by, library_ms=t11_lib)

    # ---- K13-K17 over row shards ---------------------------------------------
    g2 = (g * g).add_(rand(1e-6, positive=True))
    ga, w = g * 0.5, rand(0.03)
    m0, v0 = rand(1e-4), rand(1e-7, positive=True)
    p0 = mask.float().mul_(0.4)
    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
    scal, lscal = (3.5e-6, 0.19, 0.001999, 0.19), (3.5e-3, 0.1)
    lars = dict(mu=0.9, wd=0.01, trust=0.001, eps=1e-12)
    shards = [RowShard(layout, SPMD_SHARDS, s) for s in range(SPMD_SHARDS)]
    sh0 = shards[0]
    block_ids = layout.block_leaf_ids()[:, 0]
    edges = [s * sh0.n_blocks for s in range(1, SPMD_SHARDS) if s * sh0.n_blocks < layout.n_blocks]
    straddle = sum(int(block_ids[e - 1] == block_ids[e]) for e in edges)
    print(f"[spmd kernels] {SPMD_SHARDS} row shards of {sh0.n_blocks} blocks ({sh0.rows} rows, "
          f"{sh0.rows * 512 / 1e9:.4f} GB per f32 buffer); {sh0.pad_blocks} padding blocks; "
          f"{straddle} shard edges inside a leaf", flush=True)
    if sh0.pad_blocks == 0 or straddle == 0:
        fail("the shards must pad and straddle leaves")
    meta = [sh.device_meta(dev) for sh in shards]
    loc = [{k: sh.local(t) for k, t in dict(g=g, g2=g2, ga=ga, w=w).items()} for sh in shards]

    def scaled(want):
        return dict(atol=1e-4 * float(want.abs().max()), rtol=1e-4)

    # K13's partials are one f32 sum per leaf, the largest ~6.7e8 and the
    # smallest orders of magnitude below it: each is held to its own sum
    # (a leaf not on the shard must read exactly 0)
    tol_leaf = dict(atol=0.0, rtol=1e-4)

    errs = {k: 0.0 for k in ("leaf_r_partials", "vr_scale_apply", "vr_adam_apply",
                             "vr_lamb_compute", "vr_lars_compute", "trust_apply")}

    def note(name, *vals):
        errs[name] = max(errs[name], *vals)

    parts = []
    for s, (a, mt) in enumerate(zip(loc, meta)):
        got = fsp.leaf_r_partials(a["g"], a["g2"], mt["block_leaf_ids"], layout.leaf_slots,
                                  gsnr_eps=1e-12)
        want = fsp.leaf_r_partials_ref(a["g"], a["g2"], mt["block_leaf_ids"], layout.leaf_slots,
                                       gsnr_eps=1e-12)
        note("leaf_r_partials", check_close(f"leaf_r_partials shard {s}", got, want, tol_leaf))
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        print(f"  leaf_r_partials shard {s}: largest error relative to its leaf's sum "
              f"{rel:.3e}", flush=True)
        parts.append(got)
    racc = parts[0].clone()
    for x in parts[1:]:
        racc += x  # stands in for the all-reduce

    def whole(outs):
        return torch.cat(outs)[: layout.n_rows]

    # K14 against its plain version, and together against K8
    outs = []
    for s, (a, mt) in enumerate(zip(loc, meta)):
        args = (a["g"], a["ga"], a["g2"], racc, mt["block_leaf_ids"], mt["inv_sizes"])
        got = fsp.vr_scale_apply(*args, gamma=0.1, eps=1e-12)
        want = fsp.vr_scale_apply_ref(*args, gamma=0.1, eps=1e-12)
        note("vr_scale_apply", check_close(f"vr_scale_apply shard {s} sg", got[0], want[0],
                                           scaled(want[0])),
             check_close(f"vr_scale_apply shard {s} r", got[1], want[1], TOL_F32))
        outs.append(got)
    k8 = fu.flat_vr_scale(g, ga, g2, layout, gamma=0.1, eps=1e-12)
    for i, nm in enumerate(("sg", "r")):
        note("vr_scale_apply", check_close(f"{SPMD_SHARDS} shards of K14 vs K8: {nm}",
                                           whole([o[i] for o in outs]), k8[i], scaled(k8[i])))
    del outs, k8

    # K15 / K16 with both state dtypes, against their plain versions and K6 / K5
    times = {}
    for name, fn, ref, whole_fn in (
            ("vr_adam_apply", fsp.vr_adam_apply, fsp.vr_adam_apply_ref, fu.flat_vr_adam),
            ("vr_lamb_compute", fsp.vr_lamb_compute, fsp.vr_lamb_compute_ref, fu.flat_vr_lamb)):
        for sd_name in ("float32", "bfloat16"):
            sd = getattr(torch, sd_name)
            kw = dict(state_dtype=sd_name, **hyper)
            tol_state = (lambda want: TOL_BF16_STATE) if sd_name == "bfloat16" else scaled
            outs, accs = [], []
            for s, (sh, a, mt) in enumerate(zip(shards, loc, meta)):
                ks = [sh.local(t).to(sd, copy=True) for t in (m0, v0, p0)]
                ps = [t.clone() for t in ks]
                args = (a["g"], a["ga"], a["g2"])
                tail = (a["w"], scal, racc, mt["block_leaf_ids"], mt["inv_sizes"])
                got = fn(*args, *ks, *tail, **kw)
                want = ref(*args, *ps, *tail, **kw)
                note(name, check_close(f"{name} {sd_name} shard {s} out", got[0], want[0],
                                       scaled(want[0])),
                     *(check_close(f"{name} {sd_name} shard {s} {nm}'", x, y, tol_state(y))
                       for nm, x, y in zip("mvp", ks, ps)))
                if fn is fsp.vr_lamb_compute:
                    note(name, check_close(f"{name} {sd_name} shard {s} norm partials", got[4],
                                           want[4], scaled(want[4])))
                    accs.append(got[4])
                outs.append((got[0], *ks))
                del want, ps
            if accs:  # the trust epilogue from the summed partials
                acc = accs[0].clone()
                for x in accs[1:]:
                    acc += x
                for s, (o, mt) in enumerate(zip(outs, meta)):
                    want = fsp.trust_apply_ref(o[0].clone(), acc, mt["block_leaf_ids"],
                                               lr=scal[0], lamb=True)
                    got = fsp.trust_apply(o[0], acc, mt["block_leaf_ids"], lr=scal[0], lamb=True)
                    note("trust_apply", check_close(f"trust_apply (LAMB) {sd_name} shard {s}",
                                                    got, want, scaled(want)))
            km, kv, kp = (t.to(sd, copy=True) for t in (m0, v0, p0))
            upd = whole_fn(g, ga, g2, km, kv, kp, w, scal, layout, **kw)[0]
            single = "K5" if whole_fn is fu.flat_vr_lamb else "K6"
            note(name, check_close(f"{SPMD_SHARDS} shards vs {single} {sd_name}: upd",
                                   whole([o[0] for o in outs]), upd, scaled(upd)),
                 *(check_close(f"{SPMD_SHARDS} shards vs {single} {sd_name}: {nm}'",
                               whole([o[1 + i] for o in outs]), x, tol_state(x))
                   for i, (nm, x) in enumerate(zip("mvp", (km, kv, kp)))))
            del outs, upd, km, kv, kp
            # times on shard 0 (every shard has the same rows)
            a, mt = loc[0], meta[0]
            ks = [shards[0].local(t).to(sd, copy=True) for t in (m0, v0, p0)]
            tail = (a["w"], scal, racc, mt["block_leaf_ids"], mt["inv_sizes"])
            t_k = cuda_ms(lambda: fn(a["g"], a["ga"], a["g2"], *ks, *tail, **kw))
            t_p = cuda_ms(lambda: ref(a["g"], a["ga"], a["g2"], *ks, *tail, **kw), iters=5)
            ns = sh0.rows * 128
            b_ms, b_by = bound(5 * ns * 4 + 6 * ns * ks[0].element_size() + 4 * sh0.n_blocks,
                               40 * ns, "float32")
            times[name, sd_name] = (t_k, t_p, b_ms, b_by)
            print(f"  {name} {sd_name} state, one shard (ms): kernel={t_k:.4f} plain={t_p:.4f} "
                  f"bound={b_ms:.4f} ({b_by}); no single PyTorch call computes it", flush=True)
            del ks
            torch.cuda.empty_cache()

    # K17 and the LARS epilogue, against their plain versions and K7
    outs, accs = [], []
    for s, (a, mt) in enumerate(zip(loc, meta)):
        args = (a["g"], a["ga"], a["g2"], a["w"], lscal, racc, mt["block_leaf_ids"],
                mt["inv_sizes"])
        got = fsp.vr_lars_compute(*args, wd=lars["wd"], eps=lars["eps"])
        want = fsp.vr_lars_compute_ref(*args, wd=lars["wd"], eps=lars["eps"])
        note("vr_lars_compute",
             check_close(f"vr_lars_compute shard {s} u", got[0], want[0], scaled(want[0])),
             check_close(f"vr_lars_compute shard {s} norm partials", got[1], want[1],
                         scaled(want[1])))
        outs.append(got[0])
        accs.append(got[1])
    acc = accs[0].clone()
    for x in accs[1:]:
        acc += x
    upds, ms = [], []
    for s, (sh, u, mt) in enumerate(zip(shards, outs, meta)):
        kw = dict(lr=lscal[0], lamb=False, mu=lars["mu"], trust=lars["trust"])
        want = fsp.trust_apply_ref(u.clone(), acc, mt["block_leaf_ids"], m=sh.local(m0).clone(),
                                   **kw)
        got = fsp.trust_apply(u, acc, mt["block_leaf_ids"], m=sh.local(m0).clone(), **kw)
        note("trust_apply", *(check_close(f"trust_apply (LARS) shard {s} {nm}", x, y, scaled(y))
                              for nm, x, y in zip(("upd", "m'"), got, want)))
        upds.append(got[0])
        ms.append(got[1])
    km = m0.clone()
    upd7 = fu.flat_vr_lars(g, ga, g2, km, w, lscal, layout, **lars)[0]
    note("vr_lars_compute", check_close(f"{SPMD_SHARDS} shards vs K7: upd", whole(upds), upd7,
                                        scaled(upd7)),
         check_close(f"{SPMD_SHARDS} shards vs K7: m'", whole(ms), km, scaled(km)))
    del outs, upds, ms, upd7, km

    # times of K13, K14, K17 and the epilogues on shard 0
    a, mt = loc[0], meta[0]
    ids, inv, ns = mt["block_leaf_ids"], mt["inv_sizes"], sh0.rows * 128
    meta_b = 4 * sh0.n_blocks + 8 * layout.leaf_slots
    u0 = fsp.vr_lars_compute(a["g"], a["ga"], a["g2"], a["w"], lscal, racc, ids, inv,
                             wd=lars["wd"], eps=lars["eps"])[0]
    m_s = sh0.local(m0).clone()
    timed = {
        "leaf_r_partials": (
            lambda: fsp.leaf_r_partials(a["g"], a["g2"], ids, layout.leaf_slots, gsnr_eps=1e-12),
            lambda: fsp.leaf_r_partials_ref(a["g"], a["g2"], ids, layout.leaf_slots,
                                            gsnr_eps=1e-12),
            bound(2 * ns * 4 + meta_b, 6 * ns, "float32")),
        "vr_scale_apply": (
            lambda: fsp.vr_scale_apply(a["g"], a["ga"], a["g2"], racc, ids, inv, gamma=0.1,
                                       eps=1e-12),
            lambda: fsp.vr_scale_apply_ref(a["g"], a["ga"], a["g2"], racc, ids, inv, gamma=0.1,
                                           eps=1e-12),
            bound(5 * ns * 4 + meta_b, 10 * ns, "float32")),
        "vr_lars_compute": (
            lambda: fsp.vr_lars_compute(a["g"], a["ga"], a["g2"], a["w"], lscal, racc, ids, inv,
                                        wd=lars["wd"], eps=lars["eps"]),
            lambda: fsp.vr_lars_compute_ref(a["g"], a["ga"], a["g2"], a["w"], lscal, racc, ids,
                                            inv, wd=lars["wd"], eps=lars["eps"]),
            bound(5 * ns * 4 + meta_b, 15 * ns, "float32")),
        "trust_apply": (
            lambda: fsp.trust_apply(u0, acc, ids, lr=scal[0], lamb=True),
            lambda: fsp.trust_apply_ref(u0, acc, ids, lr=scal[0], lamb=True),
            bound(2 * ns * 4 + meta_b, 2 * ns, "float32")),
        "trust_apply_lars": (
            lambda: fsp.trust_apply(u0, acc, ids, lr=lscal[0], lamb=False, m=m_s, mu=0.9,
                                    trust=0.001),
            lambda: fsp.trust_apply_ref(u0, acc, ids, lr=lscal[0], lamb=False, m=m_s, mu=0.9,
                                        trust=0.001),
            bound(4 * ns * 4 + meta_b, 4 * ns, "float32")),
    }
    for name, (kernel, plain, (b_ms, b_by)) in timed.items():
        t_k = cuda_ms(kernel)
        t_p = cuda_ms(plain, iters=5)
        times[name] = (t_k, t_p, b_ms, b_by)
        print(f"  {name}, one shard (ms): kernel={t_k:.4f} plain={t_p:.4f} bound={b_ms:.4f} "
              f"({b_by}); no single PyTorch call computes it", flush=True)
    lines = {"leaf_r_partials": "85", "vr_scale_apply": "117", "vr_adam_apply": "142",
             "vr_lamb_compute": "187", "vr_lars_compute": "245"}
    for name in errs:
        t_k, t_p, b_ms, b_by = times.get((name, "float32"), times.get(name))
        rec = dict(name=name, route="cuda", source="src/repro_torch/kernels/csrc/flat_spmd.cu",
                   replaces=(f"src/repro/kernels/flat_spmd.py:{lines[name]}" if name in lines
                             else "src/repro/backend.py:437 (jnp epilogue, no pallas_call)"),
                   max_abs_err=errs[name], ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, shard_rows=sh0.rows)
        if (name, "bfloat16") in times:
            bt = times[name, "bfloat16"]
            rec.update(bf16_state_ms=bt[0], bf16_state_plain_ms=bt[1], bf16_state_bound_ms=bt[2])
        if name == "trust_apply":
            lt = times["trust_apply_lars"]
            rec.update(lars_ms=lt[0], lars_plain_ms=lt[1], lars_bound_ms=lt[2])
        records[name] = rec
    del g, g2, ga, w, m0, v0, p0, mask, loc, meta, u0, m_s, parts, racc, acc
    torch.cuda.empty_cache()


class TimedMesh:
    """A DataMesh whose collectives are timed on the host clock, the card
    synchronized before and after each."""

    def __init__(self, mesh):
        self.mesh, self.size, self.rank, self.device = mesh, mesh.size, mesh.rank, mesh.device
        self.wall = {}

    def _timed(self, name, fn, *args):
        import torch

        nb = args[0].numel() * args[0].element_size()
        name = f"{name} {nb / 1e9:.3f} GB" if nb > 1e6 else f"{name} (small)"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        w = self.wall.setdefault(name, [0.0, 0])
        w[0] += (time.perf_counter() - t0) * 1e3
        w[1] += 1
        return out

    def all_reduce_(self, t):
        return self._timed("all_reduce", self.mesh.all_reduce_, t)

    def all_gather(self, out, t):
        return self._timed("all_gather", self.mesh.all_gather, out, t)

    def broadcast_(self, t, src=0):
        return self._timed("broadcast", self.mesh.broadcast_, t, src)


def dp_counts(n_layers, name):
    """Launches of one rank's fused data-parallel step: K1 twice and K2 once
    per layer (one backward), K11 once, K13 and the optimizer's update kernel
    once, the trust epilogue once for LAMB and LARS; every other count 0."""
    want = fused_counts(n_layers, 1, DP_UPDATE[name], carry=None)
    want.update(flat_pack_square=1, leaf_r_partials=1)
    if name in ("vr_lamb", "vr_lars"):
        want["trust_apply"] = 1
    return want


def dp_rank(rank, world, init, out_dir, global_batch, runs):
    """One rank of a data-parallel group on the card (gloo: every rank shares
    card 0).  For each (optimizer, steps): rank 0 first runs the single-card
    k = world microbatch steps from the same weights on the same batches
    (its step-1 update and state kept on the host); then every rank runs the
    data-parallel steps, the launch counts held per step, the params checked
    bit-identical across the ranks after every step, and rank 0 holds the
    run against the single-card one within DP_TOL (compare_plans).
    Writes its counts, walls, collective walls and peak memory to
    out_dir."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.layout import FlatParams, is_flat
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import init_data_mesh
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = TimedMesh(init_data_mesh("gloo", dev, init_method=init, world_size=world, rank=rank))
    cfg = bert_train_config().replace(global_batch=global_batch)
    m = cfg.model
    label = f"dp W={world} rank {rank}"
    stream = lm_batches(m.vocab_size, global_batch, cfg.seq_len, seed=2)
    batches = [next(stream) for _ in range(max(s for _, s in runs))]
    tokens = global_batch * cfg.seq_len
    summary = {"counts": {}, "walls": {}, "peak_gib": 0.0, "collectives": {}}

    def barrier():
        mesh.mesh.all_reduce_(torch.zeros(1, device=dev))

    def flag_all(ok: bool) -> bool:
        f = torch.tensor([0.0 if ok else 1.0], device=dev)
        return float(mesh.mesh.all_reduce_(f)) == 0.0

    def params():
        return init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)

    for name, steps in runs:
        ref = None
        if rank == 0:
            rc = plan_config(cfg, "fused", name=name, k=world)
            state = init_state(rc, params=params(), device=dev)
            step = make_train_step(rc, log_gsnr=True, device=dev)[0]
            hist, first = [], {}
            for i, batch in enumerate(batches[:steps]):
                w0 = state.params.data.clone() if i == 0 else None
                state, metrics = step(state, batch)
                hist.append({k: float(v) for k, v in metrics.items()})
                if i == 0:
                    first = {"upd": (state.params.data - w0).cpu(),
                             **{nm: flat_state(state, nm).cpu() for nm in "mvp"
                                if nm in state.opt_state}}
                    del w0
            ref = (hist, first)
            del state, step
            torch.cuda.empty_cache()
        barrier()
        dc = plan_config(cfg, "fused", name=name, gsnr_source="data_axis")
        torch.cuda.reset_peak_memory_stats()
        tree = params()
        own = FlatParams(tree, m.n_groups(), device=dev).data  # this rank's seeded weights
        state = init_state(dc, params=tree, device=dev, mesh=mesh)  # rank 0's, broadcast
        if not flag_all(torch.equal(own, state.params.data)):
            raise RuntimeError(f"{label}: the seeded weights differ across the ranks")
        del own, tree
        if not all(is_flat(v) and v.shard is not None and v.shard.n_shards == world
                   for k, v in state.opt_state.items() if k in ("m", "v", "p")):
            raise RuntimeError(f"{label}: the flat state is not row-sharded")
        step = make_train_step(dc, log_gsnr=True, device=dev, mesh=mesh)[0]
        want = dp_counts(m.n_layers, name)
        hist, first, walls = [], {}, []
        for i, batch in enumerate(batches[:steps]):
            w0 = state.params.data.clone() if (i == 0 and rank == 0) else None
            reset_counts()
            (state, metrics), ms = host_ms(lambda: step(state, batch))
            counts = read_counts()
            if counts != want:
                raise RuntimeError(f"{label} {name} step {i}: launches {counts} != {want}")
            for k, c in counts.items():
                summary["counts"][k] = summary["counts"].get(k, 0) + c
            walls.append(ms)
            copy = state.params.data.clone()
            mesh.broadcast_(copy)
            if not flag_all(torch.equal(copy, state.params.data)):
                raise RuntimeError(f"{label} {name} step {i}: params differ across the ranks")
            del copy
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(list(vals.values()))):
                raise RuntimeError(f"{label} {name} step {i}: non-finite metrics {vals}")
            hist.append(vals)
            if i == 0:  # every rank takes part in the gathers
                gathered = {nm: state.opt_state[nm].shard.gather(
                    state.opt_state[nm].data, mesh).float().cpu()
                    for nm in "mvp" if nm in state.opt_state}
                if rank == 0:
                    first = {"upd": (state.params.data - w0).cpu(), **gathered}
                    del w0
                del gathered
            if rank == 0:
                print(f"  {label} {name} step {i}: {ms:.1f} ms, loss {vals['loss']:.5f} "
                      f"|g| {vals['grad_norm']:.4f} |upd| {vals['update_norm']:.4e} gsnr mean "
                      f"{vals['gsnr/mean']:.5f}; params bit-identical on {world} ranks; "
                      f"launches { {k: c for k, c in counts.items() if c} }", flush=True)
        if rank == 0:
            single = f"k{world}"
            compare_plans(f"dp W={world} {name} vs single-card k={world}",
                          {"dp": hist, single: ref[0]}, {"dp": first, single: ref[1]},
                          pair=("dp", single), tol=DP_TOL)
        summary["walls"][name] = walls
        summary["peak_gib"] = max(summary["peak_gib"],
                                  torch.cuda.max_memory_allocated() / 2**30)
        del state, step, first, ref
        torch.cuda.empty_cache()
        barrier()
    summary["collectives"] = mesh.wall
    summary["tokens"] = tokens
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(summary, f)
    mesh.mesh.close()


# (world, global batch, [(optimizer, steps)])
DP_GROUPS = (
    (2, 64, (("vr_lamb", TRAIN_STEPS), ("vr_adam", 1), ("vr_lars", 1), ("vr_sgd", 1))),
    (4, 128, (("vr_lamb", TRAIN_STEPS),)),
)
DP_DEADLINE_S = 420.0


def phase_train_dp(records):
    """10b: data-parallel bert-large at full width on the card, every rank a
    process sharing the card over gloo (NCCL refuses two ranks on one
    card).  Two ranks at global batch 64 (32 sequences per rank, phase 8's
    microbatch): three VR-LAMB steps, then one step each of VR-Adam, VR-LARS
    and VR-SGD, against single-card k=2 microbatch steps.  Four ranks at
    global batch 128, whose row shards pad the layout (44,510 blocks): three
    VR-LAMB steps against single-card k=4."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import local_init_method, run_ranks

    cfg = bert_train_config()
    path_counts = {}
    for world, batch, runs in DP_GROUPS:
        print(f"[train dp] {cfg.model.name} at full width, {cfg.model.n_layers} layers, {world} "
              f"gloo ranks on one card, global batch {batch} ({batch // world} sequences per "
              f"rank), seq {cfg.seq_len}, fused plan, data_axis GSNR (k = {world}): "
              f"{', '.join(f'{s} x {n}' for n, s in runs)}", flush=True)
        out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        t0 = time.perf_counter()
        try:
            run_ranks(dp_rank, world, args=(world, local_init_method(), out, batch, runs),
                      deadline_s=DP_DEADLINE_S)
        except Exception as e:  # a rank failed, died or hung: the phase fails
            fail(f"data-parallel group of {world} ranks: {type(e).__name__}: {e}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        shutil.rmtree(out)
        print(f"  group wall {time.perf_counter() - t0:.1f} s (spawn, init, the single-card "
              f"runs and the checks included)", flush=True)
        for r, res in enumerate(ranks):
            coll = "; ".join(f"{k} {v[0]:.1f} ms over {v[1]} calls" for k, v in
                             res["collectives"].items())
            walls = "; ".join(f"{n} {', '.join(f'{w:.1f}' for w in ws)}" for n, ws in
                              res["walls"].items())
            print(f"  rank {r}: step walls (ms, host clock) {walls}; peak memory "
                  f"{res['peak_gib']:.1f} GiB; collectives (host clock, card synchronized) "
                  f"{coll}", flush=True)
            for k, c in res["counts"].items():
                path_counts[k] = path_counts.get(k, 0) + c
        lamb = [w for res in ranks for w in res["walls"]["vr_lamb"][1:]]
        print(f"  warm VR-LAMB step wall over the ranks: {np.mean(lamb):.1f} ms = "
              f"{ranks[0]['tokens'] / np.mean(lamb) * 1e3:.0f} tokens/s on one card", flush=True)
    add_path(records, "train_dp", path_counts)


# ---------------------------------------------------------------------------
# phase 12: the per-leaf kernels (K18-K23) and their per-leaf step
# ---------------------------------------------------------------------------

# The per-leaf VR steps (per_leaf_vr_scale, per_leaf_vr_adam_update,
# per_leaf_vr_lamb_update, per_leaf_vr_lars_update) are in
# tests/torch_per_leaf_oracle.py, shared with tests/test_torch_per_leaf.py.

# Stated tolerances of phase 12: K18-K21 against their plain versions rtol
# 1e-4 with atol 1e-4 of the largest magnitude (the prepass's mean of r is
# the same plain op on both sides; the kernels' norm sums are f32 atomics over
# block partials, the plain sums pairwise); K22 as K3 (Sigma g exact, Sigma g^2
# within one FMA rounding), K23 as K4 (exact).  The per-leaf steps against
# K5-K8's flat step from the same inputs: rtol 1e-4 with atol 1e-4 of the
# largest magnitude (per-leaf sums in another order).
TOL_LEAF = 1e-4
LARGEST_LEAF = (24, 1024, 4096)  # bert-large's stacked MLP input weight


def tol_leaf(want):
    return dict(atol=TOL_LEAF * float(want.float().abs().max()), rtol=TOL_LEAF)


def check_leaves(name, paths, leaves, wants, tol):
    """check_close over matching leaves, printed as one line: the largest
    error and the leaf it is in."""
    import torch

    worst, where = 0.0, ""
    for path, got, want in zip(paths, leaves, wants):
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name} {path}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        err = (got - want).abs()
        if (err > tol["atol"] + tol["rtol"] * want.abs()).any():
            fail(f"{name} {path}: outside tol(atol={tol['atol']}, rtol={tol['rtol']}), max "
                 f"abs err {float(err.max()):.3e}")
        if float(err.max()) >= worst:
            worst, where = float(err.max()), path
    print(f"  {name}: {len(leaves)} leaves, max_abs_err={worst:.3e} ({where}) "
          f"tol(atol={tol['atol']:.3e}, rtol={tol['rtol']}) ok", flush=True)
    return worst


def phase_per_leaf(records, layout):
    """12: (a) K18-K23 against their plain versions at bert-large's largest
    stacked leaf, with times beside bounds; (b) the per-leaf path over
    bert-large's full layout: the k-microbatch moment carry leaf by leaf (K22
    per leaf per microbatch, K23 per leaf) against the flat carry (K3, K4),
    then the per-leaf VR-scale, VR-Adam, VR-LAMB and VR-LARS steps against
    K8, K6, K5 and K7's flat step from the same inputs."""
    import torch

    from repro_torch.core.gsnr import GradStats
    from repro_torch.core.layout import FlatBuffer, pad_mask
    from repro_torch.kernels import flat_stats as fs
    from repro_torch.kernels import grad_stats as gs
    from repro_torch.kernels import ops
    from repro_torch.kernels import vr_adam as va
    from repro_torch.kernels import vr_lamb as vl
    from repro_torch.kernels import vr_update as vu

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_per_leaf_oracle as plo

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def rand(shape, scale, positive=False):
        x = torch.randn(shape, generator=gen, device=dev).mul_(scale)
        return x.abs_() if positive else x

    # ---- (a) K18-K23 at the largest leaf ------------------------------------
    shape = LARGEST_LEAF
    n = int(np.prod(shape))
    print(f"[per-leaf kernels] leaf {shape}: {n / 1e6:.1f} M f32 elements, "
          f"{n * 4 / 1e9:.3f} GB a buffer", flush=True)
    g = rand(shape, 1e-2)
    x = dict(g=g, ga=g * 0.7, g2=(g * g).add_(rand(shape, 1e-4, True)), m=rand(shape, 1e-3),
             v=rand(shape, 1e-5, True), p=rand(shape, 1.0, True).clamp_(max=1.0),
             w=rand(shape, 0.05))
    del g
    bc = (0.19, 0.001999, 0.19)
    adam = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, gamma=0.1, gsnr_eps=1e-12)
    # name: (wrapper, plain, args, kw, buffers read, written, source line)
    cases = {
        "vr_scale": (vu.vr_scale, vu.vr_scale_ref, (x["g"], x["g2"], 0.1, 1e-12),
                     dict(g_apply=x["ga"]), 3, 2, "src/repro/kernels/vr_update.py:27"),
        "vr_adam_inner": (va.vr_adam_inner, va.vr_adam_inner_ref,
                          (x["g"], x["g2"], x["m"], x["v"], x["p"], *bc),
                          dict(g_apply=x["ga"], **adam), 6, 4, "src/repro/kernels/vr_adam.py:23"),
        "vr_lamb_inner": (vl.vr_lamb_inner, vl.vr_lamb_inner_ref,
                          (x["g"], x["ga"], x["g2"], x["m"], x["v"], x["p"], x["w"], *bc),
                          dict(wd=0.01, **adam), 7, 4, "src/repro/kernels/vr_lamb.py:54"),
        "vr_lars_inner": (vl.vr_lars_inner, vl.vr_lars_inner_ref,
                          (x["g"], x["ga"], x["g2"], x["w"]),
                          dict(wd=1e-4, gamma=0.1, eps=1e-12), 4, 1,
                          "src/repro/kernels/vr_lamb.py:148"),
    }
    t_pre = cuda_ms(lambda: vu.inv_mean_r(x["g"], x["g2"], 1e-12))
    for name, (kernel, plain, args, kw, n_in, n_out, line) in cases.items():
        got, want = kernel(*args, **kw), plain(*args, **kw)
        err = max(check_close(f"{name} out {i}", a, b, tol_leaf(b))
                  for i, (a, b) in enumerate(zip(got, want)))
        del got, want
        t_k = cuda_ms(lambda: kernel(*args, **kw))
        t_p = cuda_ms(lambda: plain(*args, **kw), iters=5)
        b_ms, b_by = bound((n_in + n_out) * n * 4, 40 * n, "float32")
        print(f"  {name} (ms): kernel with its prepass={t_k:.4f} (prepass alone {t_pre:.4f}) "
              f"plain={t_p:.4f} bound={b_ms:.4f} ({b_by}); no single PyTorch call computes it",
              flush=True)
        records[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/vr_leaf.cu", replaces=line,
                             max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, prepass_ms=t_pre, shape=list(shape))
    del cases
    carry = (gs.moments_init(x["g"]), gs.moments_init(x["g"]))
    plain = tuple(t.clone() for t in carry)
    for i in range(3):
        gs.moments_accum(*carry, x["g"] * (i + 1))
        gs.moments_accum_ref(*plain, x["g"] * (i + 1))
    err22 = max(check_close("moments_accum g_sum", carry[0], plain[0], TOL_EXACT),
                check_close("moments_accum g2_sum", carry[1], plain[1], TOL_CARRY))
    err23 = max(check_close(f"moments_finalize {nm}", a, b, TOL_EXACT) for nm, a, b in zip(
        ("mean", "sq_mean"), gs.moments_finalize(carry[0].clone(), carry[1].clone(), 3, shape),
        gs.moments_finalize_ref(carry[0].clone(), carry[1].clone(), 3, shape)))  # one carry
    a, b, gl = carry[0], carry[1], x["g"]
    t22 = (cuda_ms(lambda: gs.moments_accum(a, b, gl)),
           cuda_ms(lambda: gs.moments_accum_ref(a, b, gl)),
           cuda_ms(lambda: (a.view(-1).add_(gl.view(-1)), b.view(-1).addcmul_(gl.view(-1),
                                                                             gl.view(-1)))))
    t23 = (cuda_ms(lambda: gs.moments_finalize(a, b, 8, shape)),
           cuda_ms(lambda: gs.moments_finalize_ref(a, b, 8, shape)),
           cuda_ms(lambda: (a.mul_(0.125), b.mul_(0.125))))
    for name, err, (t_k, t_p, t_l), (n_io, flops), line, lib in (
            ("moments_accum", err22, t22, (5, 3), "src/repro/kernels/grad_stats.py:35",
             "add_+addcmul_"),
            ("moments_finalize", err23, t23, (4, 2), "src/repro/kernels/grad_stats.py:41",
             "2x mul_")):
        b_ms, b_by = bound(n_io * n * 4, flops * n, "float32")
        print(f"  {name} (ms): kernel={t_k:.4f} plain={t_p:.4f} {lib}={t_l:.4f} "
              f"bound={b_ms:.4f} ({b_by})", flush=True)
        records[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/flat_stats.cu", replaces=line,
                             max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                             library_ms=t_l, shape=list(shape))
    del x, carry, plain, a, b, gl
    torch.cuda.empty_cache()

    # ---- (b) the per-leaf path over bert-large's full layout -----------------
    k = 8
    print(f"[per-leaf path] {layout.n_leaves} stacked leaves of bert-large, k={k} microbatch "
          "gradients: the per-leaf carry and steps against the flat carry and steps", flush=True)
    mask = pad_mask(layout, dev)
    base = rand((layout.n_rows, 128), 1e-2).mul_(mask)
    views = lambda buf: layout.leaf_views(buf)
    reset_counts()
    carries = [(gs.moments_init(v), gs.moments_init(v)) for v in views(base)]
    flat_c = ops.moments_init_flat(layout, dev)
    t_leaf = t_flat = 0.0
    for j in range(k):  # microbatch j's gradient: the mean plus noise, bf16
        gj = (base + rand(base.shape, 1e-2).mul_(mask)).to(torch.bfloat16)
        _, ms = host_ms(lambda: [gs.moments_accum(a, b, v) for (a, b), v in
                                 zip(carries, views(gj))])
        t_leaf += ms
        _, ms = host_ms(lambda: ops.moments_accum_flat(*flat_c, gj))
        t_flat += ms
        del gj
    stats_leaf, ms = host_ms(lambda: [gs.moments_finalize(a, b, k, v.shape)
                                      for (a, b), v in zip(carries, views(base))])
    t_leaf += ms
    counts = read_counts()  # K22 and K23 only: the flat carry runs after the read
    stats, ms = host_ms(lambda: ops.moments_finalize_flat(*flat_c, k, layout))
    t_flat += ms
    print(f"  carry of {k} microbatches (host clock, synchronized): per-leaf {t_leaf:.1f} ms, "
          f"flat {t_flat:.1f} ms", flush=True)
    mean_l = [s_[0] for s_ in stats_leaf]
    sq_l = [s_[1] for s_ in stats_leaf]
    check_leaves("per-leaf carry mean vs K3/K4", layout.paths, mean_l, views(stats.mean.data),
                 TOL_EXACT)
    check_leaves("per-leaf carry sq_mean vs K3/K4", layout.paths, sq_l,
                 views(stats.sq_mean.data), TOL_CARRY)
    del carries, stats_leaf, base
    torch.cuda.empty_cache()

    grads = FlatBuffer(stats.mean.data * 0.5, layout)  # the clipped gradient entering the update
    w = FlatBuffer(rand((layout.n_rows, 128), 0.03).mul_(mask), layout)
    m0, v0 = rand((layout.n_rows, 128), 1e-4).mul_(mask), rand((layout.n_rows, 128), 1e-7,
                                                               True).mul_(mask)
    p0 = mask.float().mul_(0.4)
    lg, lsq, lga, lw = (views(t) for t in (stats.mean.data, stats.sq_mean.data, grads.data,
                                            w.data))
    lr = 3.5e-6
    adam = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
    lars = dict(mu=0.9, wd=0.01, trust=0.001, gamma=0.1, eps=1e-12)

    def compare(what, leaves, buf):
        check_leaves(f"per-leaf {what} vs flat", layout.paths, leaves, views(buf), tol_leaf(buf))

    def adam_state(clone):
        return {"step": 0, "pt": 0, **{nm: (FlatBuffer(t.clone(), layout) if clone else views(t))
                                        for nm, t in zip("mvp", (m0, v0, p0))}}

    steps = {
        "vr_scale": (lambda: plo.per_leaf_vr_scale(lg, lsq, lga, 0.1, 1e-12),
                     lambda: ops.vr_scale_tree(stats, grads, 0.1, 1e-12)),
        "vr_adam": (lambda: plo.per_leaf_vr_adam_update(lga, adam_state(False), lg, lsq,
                                                        lr, params=lw, **adam),
                    lambda: ops.vr_adam_update(grads, adam_state(True), stats, lr, params=w,
                                               **adam)),
        "vr_lamb": (lambda: plo.per_leaf_vr_lamb_update(lga, adam_state(False), lg, lsq,
                                                        lr, params=lw, **adam),
                    lambda: ops.vr_lamb_update(grads, adam_state(True), stats, lr, params=w,
                                               **adam)),
        "vr_lars": (lambda: plo.per_leaf_vr_lars_update(lga, {"step": 0, "m": views(m0)}, lg,
                                                        lsq, lr, params=lw, **lars),
                    lambda: ops.vr_lars_update(grads, {"step": 0, "m": FlatBuffer(m0.clone(),
                                                                                 layout)},
                                               stats, lr, params=w, **lars)),
    }
    for name, (leaf_step, flat_step) in steps.items():
        before = read_counts()
        got, t_l = host_ms(leaf_step)
        for nm, c in read_counts().items():
            counts[nm] += c - before[nm]
        want, t_f = host_ms(flat_step)
        if name == "vr_scale":
            compare("vr_scale sg", [a for a, _ in got], want[0].data)
            compare("vr_scale r", [r for _, r in got], want[1].data)
        else:
            compare(f"{name} upd", got[0], want[0].data)
            for nm in ("m", "v", "p"):
                if nm in got[1]:
                    compare(f"{name} {nm}'", got[1][nm], want[1][nm].data)
        print(f"  per-leaf {name} step (host clock, synchronized): {t_l:.1f} ms over "
              f"{layout.n_leaves} leaves, the flat step {t_f:.1f} ms", flush=True)
        del got, want
        torch.cuda.empty_cache()
    leaf_kernels = ("vr_scale", "vr_adam_inner", "vr_lamb_inner", "vr_lars_inner",
                    "moments_accum", "moments_finalize")
    want_counts = {nm: layout.n_leaves for nm in leaf_kernels}
    want_counts["moments_accum"] = k * layout.n_leaves
    got_counts = {nm: counts[nm] for nm in leaf_kernels}
    if got_counts != want_counts:
        fail(f"per-leaf path launches {got_counts} != {want_counts}")
    print(f"  per-leaf path launches: {got_counts}", flush=True)
    add_path(records, "per_leaf", got_counts)
    del stats, grads, w, m0, v0, p0, mask
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"capability {torch.cuda.get_device_capability(0)} is not Hopper (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(_build.sources())} sources in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)

    from repro_torch.configs import get_config

    records = {}
    layout = train_layout(get_config("bert-large"))
    phase_kernels(records)
    phase_engine(records)
    torch.cuda.empty_cache()
    phase_train_kernels(records, layout)
    scan = phase_train(records)
    phase_train_vmap(records, scan)  # against phase 8's scan steps, while they are at hand
    del scan
    torch.cuda.empty_cache()
    phase_train_optimizers(records)
    phase_spmd_kernels(records, layout)
    phase_train_dp(records)
    phase_per_leaf(records, layout)
    torch.cuda.synchronize()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in records.values():
        by_path = r.get("launches_by_path", {})
        r["launches"] = sum(by_path.values())
        if r["launches"] == 0:
            fail(f"{r['name']} was launched no time on the main paths")
        kernels.append({**{k: r[k] for k in keys},
                        **{k: v for k, v in r.items() if k not in keys}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
