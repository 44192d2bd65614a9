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
                the card could take (bound).  K12 (one cluster launch) at
                L = 1 and 4, in f32, over a 4096-slot cache and with a
                cluster of one block, also against the plain split and
                combine composed; its cluster plan (tile, chunk, splits,
                active clusters) is printed.
  4. engine   — internlm2-1.8b at full width (random weights from a seeded
                generator) through Engine.generate: batch 8, prompt 512,
                32 new tokens; launch counts of every kernel in that run
                (24 K1 per prefill, 24 K12 per decode step).
  5. reference — the same weights through the plain ("reference") attention
                plan: prefill logits and greedy tokens agree.
  6. continuous — ContinuousEngine at full width drains 8 requests.
 6b. dense serving — phi4-mini-3.8b (GQA 24/8, vocabulary 200,064, f32
                weights) and granite-20b (MQA 48/1, GELU, 20.3 B params held
                in bf16, drawn block by block) at published width and depth
                through Engine.generate (batch 8, prompt 512, 32 new tokens):
                launches, prefill ms, decode tok/s, peak memory (granite:
                one copy of its weights, the compute tree's leaves are the
                weights' storage); the fused plan held against the plain
                plan at every teacher-forced step (phase 5's gate); K1 at
                each prefill shape and K12 at each decode shape (granite:
                48 rows on one kv head, 3 row groups) against their plain
                versions, timed in turns with them and SDPA.
  7. train kernels — the training slice's kernels against their plain
                versions at the shapes its main path gives them (K10, the
                vmap path's stack reduction, at k = 8 and 7 too): the
                attention forward with its LSE and the attention backward (bert-large's B=32 S=128 H=16 D=64
                bidirectional, unpacked and on rows gather_rows packs from
                phase 13's token cache with whole pad rows (pads: out, dq,
                dk, dv exactly 0, lse -1e30), internlm2-1.8b's B=8 S=512
                H=16/8 D=128 causal packed with pads, and through the
                autograd Function), the flat moment carry (the finalize
                bit-identical to its plain version, on the full layout and
                a ragged length, and timed in turns with two mul_), the
                g-only carry (K9: bit-identical for f32 and bf16 g, full and
                ragged, timed in turns with add_; K3 and, in phase 10a,
                K11 printed beside their earlier times as controls), and the
                flat VR-LAMB, VR-Adam (f32 and bf16 state), VR-LARS and
                VR-scale updates on bert-large's full flat layout; times
                beside bounds, plain versions and library calls.
 7b. norm sums — K5 and K7 over a leaf of 131,072 blocks (2^30 elements)
                and K16/K17 on a padded row shard of it: the per-leaf sums
                of u^2 and w^2 within 1e-7 of an f64 sum, the same bits on a
                repeat (run after phase 10a).
  8. train    — bert-large at published width and depth (seeded random
                weights), seq 128, global batch 256, k=8: three VR-LAMB
                steps through make_train_step on the fused plan (every
                kernel, launch counts asserted per step) and three on the
                reference plan (plain versions) from the same params and
                batches, compared step by step; step time, tokens/s and a
                torch.profiler breakdown of one more fused step, which must
                run 4,440 GEMMs (the remat recompute stops before each
                group's last projection).
  9. train optimizers — bert-large at full width, depth cut to 2 layers
                (CUT_LAYERS), phase 8's batch: two fresh steps of each of
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
                at full width, depth cut to 2 layers (CUT_LAYERS), trained by
                ranks that share the card over gloo
                (one process per rank): two ranks at global batch 64 (two
                VR-LAMB steps, one each of VR-Adam, VR-LARS and VR-SGD)
                against single-card k=2 steps, and four ranks at global
                batch 128 (two VR-LAMB steps) against single-card k=4;
                launch counts per rank per step, params bit-identical across
                the ranks after every step, agreement within DP_TOL, step
                and collective walls, peak memory per rank.  At W = 2 also
                one VR-LAMB step with noise_scale=True (its readings equal
                on the ranks and within NOISE_RTOL's bounds of the
                single-card k = 2 ones), then the row-sharded state saved
                (gathered) and restored, each rank's rows torch.equal.
                (c) the other mesh paths, the same frame: two ranks at
                global batch 64 with the microbatch source at k = 4 (each
                microbatch's gradient reduce-scattered into the ranks'
                rows, K3/K4 on the rows): two VR-LAMB steps, VR-Adam
                fresh/stale/fresh (stale: K9 on the rows), one vmap
                VR-LAMB step (K10 on the rows) and one LAMB step, each
                against rank 0's single-card k = 4 run of the same method
                whose loss takes each group in the ranks' halves
                (rank_split_loss: the gradient rounded as the mesh rounds
                it) within DP_TOL; launches per rank per step (no K11),
                params bit-identical, each collective's wall and bytes.
                (d) FSDP+TP of the weights: bert-large at full width, depth
                cut to 2 layers, on a (2, 2) GridMesh of four gloo ranks
                sharing the card, each holding its spec blocks of every
                leaf (sharding/rules.py): global batch 64, seq 128, VR-LAMB
                k = 4 fresh, stale, fresh on the fused plan in bf16, then
                one fresh step in f32, against rank 0's one-card runs split
                over the two data ranks' rows (rank_split_loss): the
                metrics within DP_TOL, the first step's update, m, v and p
                whole and leaf by leaf within DP_TOL in f32 and
                GRID_BF16_TOL in bf16; each rank's held param and
                state elements beside the whole layout's, no flat buffer of
                the whole layout on the step's path, its peak memory,
                launches per step (K1 16, K2 8, K3 4, K4 1, K13 1, K16 1,
                trust_apply 1; stale: K9 4, trust_apply 1), every leaf's
                replicas equal, each collective's wall by kind and size.
 11. train vmap — phase 8's model, cut and batches with stats_method="vmap"
                (one vmapped forward and backward over the k groups, the
                gradient stack reduced by K10): three fresh VR-LAMB steps and
                a stale one on the fused plan (launches asserted per step:
                K1 48, K2 24, K10 1, K5 1; functorch's fallback warning an
                error) against the reference plan (TRAIN_TOL) and phase 8's
                scan steps (VMAP_TOL); step wall, tokens/s, peak memory and a
                profile beside phase 8's (555 GEMMs); two fresh VR-Adam
                steps (K1 48, K2 24, K10 1, K6 1) against the reference plan
                (TRAIN_TOL).
                Runs right after phase 8.
 12. per leaf — (a) the GSNR prepass kernel (leaf_inv_mean) against its
                plain version on the largest leaf, a ragged one, a bf16 g and
                an all-zero leaf, the same bits on a repeat, timed in turns
                with its plain version; the per-leaf kernels K18-K23 against
                their plain versions at bert-large's largest stacked leaf
                (24, 1024, 4096), K18-K21 timed with their prepass kernel
                and alone, times beside bounds; K20/K21's norm sums over the
                leaf's 2,112 blocks within 1e-7 of an f64 sum, the same bits
                on a repeat; (b) the per-leaf path over
                bert-large's layout: the k-microbatch carry leaf by leaf
                (K22, K23) against the flat carry (K3, K4) and the per-leaf
                VR-scale, VR-Adam, VR-LAMB and VR-LARS steps (K18-K21, each
                after the prepass) against the flat K8, K6, K5, K7 steps
                from the same inputs; then two device kernels per per-leaf
                VR call on the largest leaf (the call's CUDA graph).
 14. dlrm    — DLRM at published widths (configs/dlrm.py: 13 dense and 26
                sparse features, embedding 128, bottom (512, 256, 128), top
                (1024, 1024, 512, 256, 1), f32) with one cut, 2^19 rows per
                table (2^20 needs 84-98 GB of step buffers), seeded weights,
                ctr_batches at Table 5's global batch 524,288: three
                Table 11 VR-SGD steps (k = 8) through train/driver.py::
                train_optimizer on the fused plan (K3 8, K4 1, K8 1
                asserted per step) against three on the reference plan
                (DLRM_TOL_STEP0 at step 0, DLRM_TOL after: loss, each MLP
                leaf's change, the tables' change on the rows read; no
                unread table row may change), one SGD step (one backward, no kernel),
                one step on each mixed stats/optimizer plan against the
                fused step; step walls, samples/s, peak memory, a profiled
                step, the AUC on 8,192 held-out samples; K3, K4 and K8 at
                DLRM's flat layout against their plain versions (K8 also on
                mostly unclipped r, its tables-leaf mean against an f64
                sum), timed beside their bounds.  Runs before phase 15.
 13. autoscale — bert-large at full width, depth cut to 2 layers
                (CUT_LAYERS), on packed rows
                from a token cache (Markov documents over its vocabulary,
                written under build/ before phase 7 and removed at the
                end): (a) check_cache, the pack index, next_batch and the
                device prefetch (batches equal to next_batch's); (b) one
                fresh k=8 step with noise_scale=True (phase 8's launches),
                its readings against an f64 sum of its carry and against
                the reference plan's, and their device ms; (c)
                autoscale_train_loop from the cache (batch_rows 32, 8
                steps, k in [2, 8]; a second call at another k when the
                policy held k), launches asserted per step at its k, the
                LR on the sqrt rule, an epoch boundary crossed, then a
                profile of one more step; (d) a checkpoint of the state
                and the cursor restored into another seed's template
                (torch.equal), a step from each within TRAIN_TOL beside
                two runs from the same state; (e) eval_loss over an eval
                cache on both plans.  Runs after phase 11.

 15. benches — K1 and K2 at the two transformer benches' microbatch
                shapes (gengap's head dim 32 on the CUDA-core kernels)
                against their plain versions; the five ported paper-table
                benches (repro_torch/benchmarks: linreg, cifar_proxy,
                bert_proxy with its autoscale A/B, gengap, dlrm_proxy) with
                the reference's fast protocol; then one point of each on
                the fused and the reference plan (BENCH_TOL), each fused
                step's launches held.
 16. other block kinds — (a) whisper-small at its published config (12
                decoder + 12 encoder layers, d 768, 1,500 frames a row of
                stub embeddings), global batch 32, seq 128, VR-Adam k = 8:
                three steps on the reference plan, the fused plan (K1 480,
                K2 288 a fused step: the encoder, the decoder's self- and
                cross-attention and its recompute), the witness (the
                reference plan with f32 attention, its weights one f32 ulp
                apart after step 0) and the fused plan with the backward's
                delta from an f32 forward, each gap held to TRAIN_TOL
                wherever the witness's is within it, past it only through
                the exact-delta run (hold_with_witness); warm step,
                tokens/s and a profiled step's idle share; (b) xlstm-1.3b
                at full width on two pattern groups (16 layers), the same
                way, two steps; (c) mixtral-8x22b (8 of 56 layers, bf16),
                recurrentgemma-9b and llama-3.2-vision-11b (1,601 image
                tokens) at published width and depth through
                Engine.generate (batch 4, prompt 256, 16 new tokens):
                launches, prefill ms, decode tok/s, peak memory, the fused
                plan held against the plain plan at every teacher-forced
                step within SERVE_GATE; mixtral's routing flips held to
                ROUTE_GATE against the witness's, SERVE_GATE then taken
                against the plain plan routed as the fused run; (d) one
                VR-LAMB step of the llama4-maverick and mixtral smokes
                (bf16) held as (a), their routing flips counted; (e) K1 (and
                K2) at whisper's encoder (S 1,500) and cross (Skv 1,500)
                shapes, K1 at the vision model's cross prefill (Skv 1,601,
                D 128) and K1/K12 at recurrentgemma's head dim 256, against
                their plain versions, timed in turns with them and SDPA,
                beside their bounds.  Runs last.

The second-last lines are the kernel JSON record and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores

# Stated tolerances.  Kernel and plain version both accumulate in f32 from
# the same inputs; they differ in summation order and exp rounding (~1e-6
# relative), so f32 results (lse, partials) agree to 1e-4.  The bf16
# attention kernels also round P to bf16 as the tensor cores' operand of
# P V, at most 2^-9 relative per term, below the output's own ulp.  A bf16
# output can then round to a neighbouring value: 1 bf16 ulp is 2^-7 of the
# magnitude, and outputs here stay below 4, hence 2e-2.
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_BF16_OUT = dict(atol=2e-2, rtol=2e-2)

# The bf16 attention kernels' first versions, on the CUDA cores (PERF.md:
# chip calls 4 and 6 of PR 12, H100 80GB HBM3 at 700 W), printed beside this
# run's tensor-core times; they enter no check and no record.
CUDA_CORE_MS = {"K1 serving": 0.48899, "K1 bert with_lse": 0.117472, "K2 bert": 0.308928,
                "K2 internlm2": 0.74224}
# K12's first version, a split and a combine launch (PERF.md's kernel
# table, H100 80GB HBM3 at 700 W), printed beside this run's one-launch
# time; it enters no check and no record.
TWO_LAUNCH_DECODE_MS = {"split": 0.022624, "combine": 0.0112}
# Kernels left on the grid-stride loop, as controls beside K9's one-pass
# loop: their earlier times (PERF.md's kernel table and findings, H100
# 80GB HBM3 at 700 W), printed beside this run's times only.
EARLIER_MS = {"flat_moments_accum": "2.5180-2.5273", "flat_pack_square": "1.8047"}


# Rows per chunk of check_close: a check of DLRM's (13.6 M, 128) buffers
# then needs no buffer-sized temporaries.
CHECK_ROWS = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_close(name, got, want, tol):
    """|got - want| <= atol + rtol |want| elementwise, taken over
    CHECK_ROWS-row chunks so that buffers of several GB need no temporaries
    of their size; returns the largest |got - want|."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    got, want = got.reshape(-1, *got.shape[1:]), want.reshape(-1, *want.shape[1:])
    max_err, n_bad = 0.0, 0
    for i in range(0, want.shape[0], CHECK_ROWS):
        a, b = got[i: i + CHECK_ROWS].float(), want[i: i + CHECK_ROWS].float()
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite values")
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        n_bad += int((err > tol["atol"] + tol["rtol"] * b.abs()).sum())
    print(f"  {name}: max_abs_err={max_err:.3e} tol(atol={tol['atol']}, rtol={tol['rtol']}) "
          f"{'ok' if not n_bad else 'FAIL'}", flush=True)
    if n_bad:
        fail(f"{name}: {n_bad} elements outside tolerance")
    return max_err


def _graph(fn):
    """fn() captured once in a CUDA graph, after three warm-up calls on a
    side stream."""
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
    return graph


def _replay_ms(graph) -> float:
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_ms(fn, iters: int = 25) -> float:
    """Device time of fn(): the call is captured once in a CUDA graph, and the
    median over ``iters`` replays, each between two CUDA events, is taken.
    Replaying leaves out the host's time to issue the calls, which for small
    kernels would otherwise be what the events measure."""
    graph = _graph(fn)
    return float(np.median([_replay_ms(graph) for _ in range(iters)]))


def cuda_ms_interleaved(fns, iters: int = 25):
    """{name: device ms} of several calls timed in turns: each is captured in
    a CUDA graph, then the graphs are replayed one after another for
    ``iters`` rounds (a, b, a, b, ...) and the median of each is taken, so
    a difference of a few percent does not depend on which ran first."""
    graphs = {name: _graph(fn) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(iters):
        for name, graph in graphs.items():
            times[name].append(_replay_ms(graph))
    return {name: float(np.median(t)) for name, t in times.items()}


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
          f"sdpa={t_lib:.4f} bound={b_ms:.4f} ({b_by}); CUDA-core version "
          f"{CUDA_CORE_MS['K1 serving']} (PR 12)", flush=True)
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

    # ---- K12 flash_decode: one cluster launch ----------------------------
    print("[kernels] flash_decode (one launch: the splits of a cluster merged in distributed "
          "shared memory)", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, t = [], {}
    # (label, B, C, lanes, kv heads, head dim, filled slots, dtype); the first
    # is the serving decode shape, the last two a cache long enough that a
    # block walks several tiles, and enough rows that each cluster is one block
    cases = [("serving L=1", 8, 552, 1, kvh, d, 368, torch.bfloat16),
             ("serving L=4", 8, 552, 4, kvh, d, 368, torch.bfloat16),
             ("f32 D=64 L=2", 4, 256, 2, 2, 64, 180, torch.float32),
             ("long cache C=4096", 4, 4096, 1, kvh, d, 3000, torch.bfloat16),
             ("cluster of one block", 64, 552, 1, kvh, d, 368, torch.bfloat16)]
    for label, b, c, lanes, kvd, dd, fill, dtype in cases:
        hd = kvd * (h // kvh)
        qd = randn(b, lanes, hd, dd, dtype=dtype)
        kc, vc = randn(b, c, kvd, dd, dtype=dtype), randn(b, c, kvd, dd, dtype=dtype)
        qp, kp, qs, ks = (ints(a) for a in paged_cache(b, c, lanes, fill, rng))
        tile, chunk, ns = fd.split_plan(b, kvd, (hd // kvd) * lanes, c, n_sm)
        blocks = b * kvd * -(-(hd // kvd) * lanes // fd.ROWS_PER_BLOCK) * ns
        active = fd.active_clusters(qd, kc)
        print(f"  {label} (B={b} C={c} L={lanes} H={hd}/{kvd} D={dd} {str(dtype)[6:]}): "
              f"tile={tile} chunk={chunk} splits={ns} (cluster of {ns} blocks) blocks={blocks} "
              f"(SMs {n_sm}) active clusters={active}", flush=True)
        if active < 1:
            fail(f"{label}: no cluster of {ns} blocks fits on the card")
        if blocks < 2 * n_sm and chunk != tile and ns != fd.MAX_SPLITS:
            fail("the cluster plan does not cover the SMs twice")
        if label.startswith("cluster of one") and ns != 1:
            fail(f"{label}: the plan has {ns} splits")
        tol = TOL_BF16_OUT if dtype == torch.bfloat16 else TOL_F32
        full = fd.flash_decode(qd, kc, vc, qp, kp, qs, ks)
        want = fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks)
        errs.append(check_close(f"{label} flash_decode vs decode_attention_ref", full, want, tol))
        m, l, acc = fd.decode_split_ref(qd, kc, vc, qp, kp, qs, ks, causal=True, window=0,
                                        chunk=chunk)
        errs.append(check_close(f"{label} flash_decode vs decode_combine_ref(decode_split_ref)",
                                full, fd.decode_combine_ref(m, l, acc, dtype), tol))
        del m, l, acc
        if full[qp < 0].abs().max() != 0:
            fail("idle lanes must give exactly 0")
        if label != "serving L=1":
            continue
        # timings at the serving decode shape
        dmask = fa.attention_mask(qp, kp, qs, ks, causal=True)
        pairs = int(dmask.sum()) * h
        qt = qd.transpose(1, 2).contiguous()
        kt = kc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        vt = vc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        amask = dmask[:, None]
        t = cuda_ms_interleaved({
            "kernel": lambda: fd.flash_decode(qd, kc, vc, qp, kp, qs, ks),
            "plain": lambda: fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)})
        # K/V bytes: only the slots this run's queries attend (live slots of
        # rows with a live lane); the rest of the cache need not be read
        kv_need = int(dmask.any(dim=1).sum()) * kvh * d * kc.element_size() * 2
        print(f"  K/V the decode needs: {kv_need / 1e6:.2f} MB of the cache's "
              f"{nbytes(kc, vc) / 1e6:.2f} MB", flush=True)
        t["bound"] = bound(nbytes(qd, qp, kp, qs, ks, full) + kv_need, pairs * 4 * d, "bfloat16")
        # what this timer reports for one launch that does next to nothing
        one = torch.zeros(1, device=dev)
        t["floor"] = cuda_ms(lambda: one.add_(1))
        t["plan"] = dict(tile=tile, chunk=chunk, splits=ns, blocks=blocks, active_clusters=active)
    f_ms, f_by = t["bound"]
    print(f"  flash_decode at the serving shape (ms): kernel={t['kernel']:.6f} "
          f"plain decode_attention_ref={t['plain']:.6f} sdpa={t['sdpa']:.6f} "
          f"bound={f_ms:.6f} ({f_by}); plan {t['plan']}; the first version's split + combine, "
          f"two launches: {TWO_LAUNCH_DECODE_MS}; this timer's floor (one add_ on one element) "
          f"{t['floor']:.6f}", flush=True)
    records["flash_decode"] = dict(
        name="flash_decode", route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:43", max_abs_err=max(errs), ms=t["kernel"],
        plain_ms=t["plain"], bound_ms=f_ms, bound_by=f_by, library_ms=t["sdpa"], plan=t["plan"],
        timer_floor_ms=t["floor"],
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
            "flash_decode": fd.flash_decode,
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
            "leaf_inv_mean": vu.leaf_inv_mean,
            "moments_accum": gs.moments_accum,
            "moments_finalize": gs.moments_finalize,
            "leaf_r_partials": fsp.leaf_r_partials,
            "vr_scale_apply": fsp.vr_scale_apply,
            "vr_adam_apply": fsp.vr_adam_apply,
            "vr_lamb_compute": fsp.vr_lamb_compute,
            "vr_lars_compute": fsp.vr_lars_compute,
            "trust_apply": fsp.trust_apply}


SERVE_KERNELS = ("flash_attention_fwd", "flash_decode")


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


def device_profile(fn, cpu=False):
    """(device-busy ms, kernel launches, per-kernel rows by device time) of
    one fn() call, from torch.profiler's CUDA events; busy is None if the
    profiler saw no device time.  The device's activity alone is recorded
    (``cpu=True`` adds the CPU's, and is the fallback where that shows no
    device time), and its raw events are summed by name without building
    the profiler's event tree: that tree took 40.6 s for xlstm-1.3b's step
    of 145,806 launches, and 131.3 s with the CPU's events (H100 80GB
    HBM3, 700 W; PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    if not by_name:
        return (None, 0, []) if cpu else device_profile(fn, cpu=True)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def graph_kernels(fn):
    """(kernel launches, memsets) of one fn() call, counted as the kernel
    and memset nodes of that call captured in a CUDA graph (libcuda's
    cuGraphGetNodes), so without the profiler.  fn() runs once first on
    the capture stream, so state a wrapper makes on first use there (the
    prepass's block counter) is not captured."""
    import ctypes

    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        fail("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return kinds.count(0), kinds.count(2)  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMSET


# device-time categories of a profile, by kernel name: the port's kernels,
# cuBLAS GEMMs, and the rest (element-wise, copies, reductions)
PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel", "flash_fwd_wgmma_kernel",
                "flash_bwd_wgmma_kernel", "decode_kernel", "accum_kernel", "finalize_kernel",
                "r_sums_kernel", "adam_kernel", "apply_kernel", "scale_kernel",
                "lars_compute_kernel", "vmap_moments_kernel", "leaf_")


def category(key: str) -> str:
    if any(k in key for k in PORT_KERNELS):
        return "port kernels"
    if "nvjet" in key or "gemm" in key.lower() or "cutlass" in key:
        return "GEMMs"
    return "other (element-wise, copies, reductions)"


def report_profile(name, fn, wall_ms, top: int = 6):
    """Print the profile of one fn() call and the seconds it took; returns
    {category: [ms, launches]} (None if the profiler saw no device time)."""
    t0 = time.perf_counter()
    busy, launches, rows = device_profile(fn)
    took = time.perf_counter() - t0
    if busy is None:
        print(f"  {name}: wall {wall_ms:.2f} ms; device time not measured (no CUDA events); "
              f"profiled in {took:.1f} s", flush=True)
        return None
    print(f"  {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall_ms:.3f}), {launches} kernel launches; profiled in "
          f"{took:.1f} s", flush=True)
    cats = {}
    for key, ms, n in rows:
        c = cats.setdefault(category(key), [0.0, 0])
        c[0] += ms
        c[1] += n
    print("    by category: " + "; ".join(f"{c} {ms:.2f} ms x{n}" for c, (ms, n) in cats.items()),
          flush=True)
    for key, ms, n in rows[:top]:
        print(f"    {ms:8.3f} ms  x{n:<5d} {key[:90]}", flush=True)
    return cats


def check_gemms(name, cats, want):
    """The matrix products of one profiled step: the remat recompute stops
    before each group's last projection, so a step runs ``want`` GEMMs."""
    got = None if cats is None else cats.get("GEMMs", [0.0, 0])[1]
    print(f"  {name}: {got} GEMM launches (want {want})", flush=True)
    if got != want:
        fail(f"{name}: {got} GEMM launches, want {want}")


def step_gemms(m, passes):
    """GEMM launches of a fused step: per pass and layer 6 forward products
    (q, k, v, o, wi, wd), 5 of the remat's recompute (all but wd) and 12
    backward, then 3 of the LM head (forward, its two gradients)."""
    return passes * (m.n_layers * (6 + 5 + 12) + 3)


# The serving gate: both plans run the same bf16 projections; attention
# differs in rounding (the kernel keeps scores and p in f32, the plain path
# rounds scores and weights to bf16), and the difference compounds over the
# layers.  Measured on an H100 (700 W) with internlm2-1.8b: prefill max
# |diff| 0.095, mean 0.015, on logits of std ~1.  Bounds: max 0.5, mean 0.05.
SERVE_GATE = {"max": 0.5, "mean": 0.05}


def check_logits(what, a, c):
    diff = (a - c).abs()
    print(f"  {what} logits: max |fused - reference| = {float(diff.max()):.4f}, "
          f"mean {float(diff.mean()):.5f}, logit std {float(c.std()):.3f} "
          f"(tol max {SERVE_GATE['max']}, mean {SERVE_GATE['mean']})", flush=True)
    if not (float(diff.max()) <= SERVE_GATE["max"] and float(diff.mean()) <= SERVE_GATE["mean"]):
        fail(f"{what} logits of the fused and reference plans disagree")
    return float(diff.max()), float(diff.mean())


def hold_plans(eng, reng, prompts, res, n_layers):
    """Teacher-forced along the fused plan's tokens ``res.tokens``: each
    plan's own prefill and decode steps are fed the prompt and then every
    token the fused engine emitted, so at every step both score the same
    context (step 0 is the prefill).  The logits must agree at every step
    (SERVE_GATE), the fused run must launch K1 in every layer and K12 in
    every layer of every decode step, and the fused token must be a near-top
    choice of the reference: its reference logit within twice the measured
    max |fused - reference| of the reference's top-1 (the most two logits
    can swap by under that difference).  Returns (max, mean) |diff|."""
    import torch

    dev = eng.device
    b, s = prompts.shape
    new = res.tokens.shape[1]
    toks = torch.as_tensor(prompts, device=dev)
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
                "flash_attention_fwd": n_layers, "flash_decode": n_layers * (new - 1)}:
            fail(f"the fused plan did not launch the kernels in every layer: {got}")
        tf_r = teacher_forced(reng)
    gate = check_logits(f"teacher-forced, all {new} steps,", tf_f, tf_r)
    gap_tol = 2 * gate[0]
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
    return gate


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
    want = {"flash_attention_fwd": m.n_layers, "flash_decode": m.n_layers * new}
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
    rres, t_ref = host_ms(lambda: reng.generate(prompts, new))
    print(f"  reference plan generate(B={b}, prompt={s}, new={new}): {t_ref:.1f} ms "
          f"(fused plan {t_total:.1f} ms)", flush=True)
    same = int((res.tokens == rres.tokens).all(axis=1).sum())
    print(f"  greedy tokens identical on {same}/{b} rows", flush=True)
    hold_plans(eng, reng, prompts, res, m.n_layers)
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
# phase 6b: phi4-mini-3.8b and granite-20b served at full width
# ---------------------------------------------------------------------------

# The two dense configs beside internlm2-1.8b, at published width and depth:
# phi4-mini-3.8b (GQA, a group of 3 query heads on each of 8 kv heads,
# vocabulary 200,064) with f32 weights, as phase 4's model; granite-20b (MQA:
# 48 query heads on one kv head) with its weights held in bf16 (its f32
# weights, ~81 GB, do not fit the 80 GB card), drawn block by block and
# rounded as drawn (models/transformer.py::init_params), so both plans compute
# what f32 weights of those values would.  The dtype is the serving
# launcher's choice (launch/serve.py::weight_dtype), held to these.
DENSE_SERVE = {"phi4-mini-3.8b": "float32", "granite-20b": "bfloat16"}


def attention_shapes(records, tag, b, s, h, kvh, d, cache_len, fill):
    """K1 at a model's prefill shape (B, S causal, H/KV heads) and K12 at its
    decode shape (one lane per row over a ``cache_len`` cache with ``fill``
    live slots), each against its plain version and timed in turns with it
    and SDPA (K/V expanded to every query head), beside its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev,
                                                                                   torch.bfloat16)

    q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
    got = fa.flash_attention(q, k, v, causal=True)
    err1 = check_close(f"{tag} K1 B{b} S{s} H{h}/{kvh} D{d} causal out", got,
                       fa.attention_fwd_ref(q, k, v, causal=True)[0], TOL_BF16_OUT)
    qp, _, qs, _ = fa.resolve_positions(None, None, s, s, device=dev)
    qp, qs = qp.expand(b, s).contiguous(), qs.expand(b, s).contiguous()
    mask = fa.attention_mask(qp, qp, qs, qs, causal=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = kt.repeat_interleave(h // kvh, dim=1), vt.repeat_interleave(h // kvh, dim=1)
    amask = mask[:, None]
    t1 = cuda_ms_interleaved({
        "kernel": lambda: fa.flash_attention(q, k, v, causal=True),
        "plain": lambda: fa.attention_fwd_ref(q, k, v, causal=True),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)})
    b1 = bound(nbytes(q, k, v, qp, qp, qs, qs, got), int(mask.sum()) * h * 4 * d, "bfloat16")
    print(f"  {tag} K1 (ms): kernel={t1['kernel']:.4f} plain={t1['plain']:.4f} "
          f"sdpa={t1['sdpa']:.4f} bound={b1[0]:.4f} ({b1[1]})", flush=True)
    del q, k, v, qt, kt, vt, got, amask, mask

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    qd = randn(b, 1, h, d)
    kc, vc = randn(b, cache_len, kvh, d), randn(b, cache_len, kvh, d)
    qp, kp, qs, ks = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in paged_cache(b, cache_len, 1, fill, rng))
    tile, chunk, ns = fd.split_plan(b, kvh, h // kvh, cache_len, n_sm)
    groups = -(-(h // kvh) // fd.ROWS_PER_BLOCK)
    full = fd.flash_decode(qd, kc, vc, qp, kp, qs, ks)
    err12 = check_close(f"{tag} K12 B{b} C{cache_len} L1 H{h}/{kvh} D{d} ({groups} row groups of "
                        f"{fd.ROWS_PER_BLOCK} per kv head, {ns} splits)", full,
                        fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks), TOL_BF16_OUT)
    dmask = fa.attention_mask(qp, kp, qs, ks, causal=True)
    qt = qd.transpose(1, 2).contiguous()
    kt = kc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    vt = vc.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    amask = dmask[:, None]
    t12 = cuda_ms_interleaved({
        "kernel": lambda: fd.flash_decode(qd, kc, vc, qp, kp, qs, ks),
        "plain": lambda: fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)})
    kv_need = int(dmask.any(dim=1).sum()) * kvh * d * kc.element_size() * 2
    b12 = bound(nbytes(qd, qp, kp, qs, ks, full) + kv_need, int(dmask.sum()) * h * 4 * d,
                "bfloat16")
    print(f"  {tag} K12 (ms): kernel={t12['kernel']:.6f} plain={t12['plain']:.6f} "
          f"sdpa={t12['sdpa']:.6f} bound={b12[0]:.6f} ({b12[1]}); plan tile={tile} "
          f"chunk={chunk} splits={ns}", flush=True)
    for name, err, t, bd, shape in (
            ("flash_attention_fwd", err1, t1, b1, f"B{b} S{s} H{h}/{kvh} D{d} bf16 causal"),
            ("flash_decode", err12, t12, b12, f"B{b} C{cache_len} L1 H{h}/{kvh} D{d} bf16")):
        r = records[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r[tag] = dict(shape=shape, max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                      library_ms=t["sdpa"], bound_ms=bd[0], bound_by=bd[1])


def serve_dense(records, arch, param_dtype):
    import torch

    from repro_torch.backend import Backend
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import weight_dtype
    from repro_torch.models import init_params
    from repro_torch.serve import Engine

    dev = torch.device("cuda")
    cfg = get_config(arch)
    m = cfg.model
    if weight_dtype(cfg, dev) != getattr(torch, param_dtype):
        fail(f"{arch}: the serving launcher holds the weights in {weight_dtype(cfg, dev)}, "
             f"not {param_dtype}")
    b, s, new = 8, 512, 32
    cache_len = s + new + 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=getattr(torch, param_dtype))
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    eng = Engine(cfg, params, cache_len=cache_len, device=dev)
    print(f"[dense serve] {m.name}: {n_params / 1e9:.3f} B params (analytic "
          f"{m.param_count() / 1e9:.3f} B), {m.n_layers} layers, d_model {m.d_model}, heads "
          f"{m.n_heads}/{m.n_kv_heads}, d_ff {m.d_ff}, act {m.act}, vocab {m.vocab_size}; "
          f"weights held in {param_dtype}: {w_bytes / 1e9:.2f} GB, drawn in {t_init:.1f} s at a "
          f"peak of {init_peak / 1e9:.2f} GB", flush=True)
    if n_params != m.param_count() + m.d_model:
        fail(f"{arch}: param count differs from the config's analytic count")
    # one copy of the weights: a compute-dtype leaf of a bf16 weight is that
    # weight's own storage
    ptrs = {t.data_ptr() for t in leaves}
    copies = sum(1 for t in _leaves(eng.model.params) if t.data_ptr() not in ptrs)
    if param_dtype == "bfloat16" and copies:
        fail(f"{arch}: {copies} leaves of the compute tree are copies of the weights")
    prompts = np.random.default_rng(1).integers(0, m.vocab_size, size=(b, s))
    eng.generate(prompts, 2)  # warm-up
    _, t_prefill = host_ms(lambda: eng.generate(prompts, 0))
    reset_counts()
    res, t_total = host_ms(lambda: eng.generate(prompts, new))
    counts = read_counts()
    want = {"flash_attention_fwd": m.n_layers, "flash_decode": m.n_layers * new}
    want.update({name: 0 for name in counts if name not in SERVE_KERNELS})
    if counts != want:
        fail(f"{arch}: launch counts {counts} != expected {want}")
    for name in SERVE_KERNELS:
        records[name].setdefault("launches_by_path", {})[f"serve {arch}"] = counts[name]
    if res.tokens.shape != (b, new) or not np.isfinite(res.logprobs).all():
        fail(f"{arch}: generate returned {res.tokens.shape} tokens / non-finite logprobs")
    if not ((res.tokens >= 0) & (res.tokens < m.vocab_size)).all():
        fail(f"{arch}: generated tokens out of vocabulary")
    decode_ms = t_total - t_prefill
    peak = torch.cuda.max_memory_allocated() - base
    flops = 2 * (n_params - m.vocab_size * m.d_model) * b * s
    print(f"  launches in generate: {{'flash_attention_fwd': {counts['flash_attention_fwd']}, "
          f"'flash_decode': {counts['flash_decode']}}}, none else; prefill (B={b}, S={s}) "
          f"{t_prefill:.1f} ms (host clock; {flops / 1e12:.1f} TFLOP of projections = "
          f"{flops / t_prefill / 1e9:.0f} TFLOP/s); decode {new} steps {decode_ms:.1f} ms = "
          f"{b * new / decode_ms * 1e3:.1f} tok/s; peak memory {peak / 1e9:.2f} GB "
          f"(weights {w_bytes / 1e9:.2f} GB; {copies} compute leaves not the weights' "
          f"storage)", flush=True)
    with torch.no_grad():
        toks = torch.as_tensor(prompts, device=dev)
        _, t_pre = host_ms(lambda: eng._prefill(toks))
        report_profile(f"{arch} prefill (profiled)", lambda: eng._prefill(toks), t_pre)
    rcfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, backend=Backend.all_reference()))
    reng = Engine(rcfg, params, cache_len=cache_len, device=dev)
    gate = hold_plans(eng, reng, prompts, res, m.n_layers)
    records.setdefault("_dense_serve", {})[arch] = dict(
        prefill_ms=t_prefill, decode_tok_s=b * new / decode_ms * 1e3, peak_gb=peak / 1e9,
        weights_gb=w_bytes / 1e9, gate_max=gate[0], gate_mean=gate[1])
    del eng, reng, params, leaves
    torch.cuda.empty_cache()
    hd = m.resolved_head_dim
    attention_shapes(records, arch, b, s, m.n_heads, m.n_kv_heads, hd, cache_len, s + new)


def phase_dense_serving(records):
    for arch, param_dtype in DENSE_SERVE.items():
        serve_dense(records, arch, param_dtype)


# ---------------------------------------------------------------------------
# phase 7: the training kernels at the main path's shapes
# ---------------------------------------------------------------------------

# Stated tolerances of the training kernels.  The attention backward and its
# plain version accumulate in f32 from the same bf16 inputs and round the
# gradients to bf16 (dq is summed in f32 first); the kernel also rounds P
# and dS to bf16 as tensor-core operands, at most 2^-9 relative per term,
# below the gradients' own ulp.  So an element may land on a neighbouring
# bf16 value: one ulp, at most 2^-7 of its magnitude.
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


def phase_train_kernels(records, layout, data):
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
          f"sdpa={t1_lib:.4f} bound={b1_ms:.4f} ({b1_by}); CUDA-core version "
          f"{CUDA_CORE_MS['K1 bert with_lse']} (PR 12)", flush=True)
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
          f"sdpa backward={t_lib:.4f} bound={b_ms:.4f} ({b_by}); CUDA-core version "
          f"{CUDA_CORE_MS['K2 bert']} (PR 12)", flush=True)

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
          f"sdpa backward={t2_lib:.4f} bound={b2_ms:.4f} ({b2_by}); CUDA-core version "
          f"{CUDA_CORE_MS['K2 internlm2']} (PR 12)", flush=True)

    # packed bidirectional rows at bert's training shape: phase 13's rows as
    # gather_rows packs them, with whole pad rows (position -1 throughout)
    pos3 = torch.from_numpy(packed_tail_rows(data, b)["positions"]).to(dev)
    q3, k3, v3, do3 = (randn(b, s, h, d) for _ in range(4))
    fwd_err3, err_packed, args3, got3 = check_attention_bwd(
        "bert B32 S128 H16 D64 bf16 bidirectional packed", q3, k3, v3, do3, pos3, False)
    dead = args3[6] < 0
    whole = int(dead.all(dim=1).sum())
    out3, lse3 = fa.flash_attention(q3, k3, v3, *args3[6:], causal=False, with_lse=True)
    pads = {"out": out3[dead], "dq": got3[0][dead], "dk": got3[1][dead], "dv": got3[2][dead]}
    if whole < 1 or any(bool(t.any()) for t in pads.values()) or \
            not bool((lse3.transpose(1, 2)[dead] == -1e30).all()):
        fail("packed bert shape: pad rows must give out, dq, dk, dv exactly 0 and lse -1e30 "
             f"({whole} whole pad rows)")
    print(f"  packed bert shape: {int(dead.sum())} pad positions ({whole} whole pad rows) give "
          "out, dq, dk, dv exactly 0 and lse -1e30", flush=True)
    records["flash_attention_fwd"]["max_abs_err"] = max(
        records["flash_attention_fwd"]["max_abs_err"], fwd_err3)
    mask3 = fa.attention_mask(*args3[6:], causal=False)
    tp_fwd = cuda_ms(lambda: fa.flash_attention(q3, k3, v3, *args3[6:], causal=False,
                                                with_lse=True))
    tp_kernel = cuda_ms(lambda: fab.flash_attention_bwd(*args3, causal=False))
    tp_plain = cuda_ms(lambda: fab.attention_bwd_ref(
        *args3[:6], causal=False, q_pos=args3[6], k_pos=args3[7], q_seg=args3[8],
        k_seg=args3[9]))
    tp_lib = sdpa_bwd_ms(q3, k3, v3, do3, mask3)
    live_pairs = int(mask3.sum()) * h
    bpf_ms, bpf_by = bound(nbytes(q3, k3, v3, *args3[6:], q3, lse3), live_pairs * 4 * d,
                           "bfloat16")
    bp_ms, bp_by = bound(nbytes(*args3, *got3), live_pairs * 10 * d, "bfloat16")
    print(f"  packed bert times (ms): K1 with_lse={tp_fwd:.4f} (unpacked {t1:.4f}, bound "
          f"{bpf_ms:.4f} {bpf_by}); K2={tp_kernel:.4f} (unpacked {t_kernel:.4f}) plain="
          f"{tp_plain:.4f} sdpa backward={tp_lib:.4f} bound={bp_ms:.4f} ({bp_by})", flush=True)
    records["flash_attention_fwd"].update(packed_train_ms=tp_fwd, packed_train_bound_ms=bpf_ms)
    packed_bwd = dict(packed_ms=tp_kernel, packed_plain_ms=tp_plain, packed_bound_ms=bp_ms,
                      packed_library_ms=tp_lib)
    del q3, k3, v3, do3, args3, got3, out3, lse3, pads, mask3

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
        max_abs_err=max(err_bert, err_intern, err_packed, err_fn), ms=t_kernel,
        plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        internlm2_ms=t2_kernel, internlm2_plain_ms=t2_plain, internlm2_bound_ms=b2_ms,
        internlm2_library_ms=t2_lib, **packed_bwd,
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
    # K4: bit-identical to its plain version (x * f32(1/k), rounded once) on
    # the full layout and on a length that is a multiple of 4 floats but not
    # of the kernel's unroll x block; timed in turns with two mul_
    ragged = torch.randn(4 * 31_111, generator=gen, device=dev)
    for what, (a, b) in (("bert-large layout", (pg, pg2)),
                         ("ragged length", (ragged, ragged.abs()))):
        km, ksq = fs.flat_moments_finalize(a.clone(), b.clone(), 8)
        pm, psq = fs.moments_finalize_ref(a.clone(), b.clone(), 8)
        if not (torch.equal(km, pm) and torch.equal(ksq, psq)):
            fail(f"flat_moments_finalize on the {what} is not bit-identical to its plain version")
        print(f"  flat_moments_finalize on the {what} ({a.numel()} floats): torch.equal ok",
              flush=True)
    err4 = 0.0
    t4 = cuda_ms_interleaved({"kernel": lambda: fs.flat_moments_finalize(gs, g2s, 8),
                              "lib": lambda: (gs.mul_(0.125), g2s.mul_(0.125)),
                              "plain": lambda: fs.moments_finalize_ref(gs, g2s, 8)})
    b4_ms, b4_by = bound(4 * n * 4, 2 * n, "float32")
    print(f"  flat_moments_finalize (ms, in turns): kernel={t4['kernel']:.6f} "
          f"2x mul_={t4['lib']:.6f} plain={t4['plain']:.6f} bound={b4_ms:.6f} ({b4_by}); "
          f"{b4_ms / t4['kernel'] * 100:.1f} % of the bound (2x mul_ "
          f"{b4_ms / t4['lib'] * 100:.1f} %)", flush=True)
    records["flat_moments_accum"] = dict(
        name="flat_moments_accum", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/grad_stats.py:35", max_abs_err=err3, ms=t3,
        plain_ms=t3_plain, bound_ms=b3_ms, bound_by=b3_by, library_ms=t3_lib)
    records["flat_moments_finalize"] = dict(
        name="flat_moments_finalize", route="cuda",
        source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/grad_stats.py:41", max_abs_err=err4, ms=t4["kernel"],
        plain_ms=t4["plain"], bound_ms=b4_ms, bound_by=b4_by, library_ms=t4["lib"])
    del gs, g2s, g, kg, kg2, pg, pg2, km, ksq, pm, psq, ragged

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
    # bit-identical to its plain version (add_ of g cast to f32) for f32 and
    # bf16 g, on the full layout and on a length of whole float4 that is not
    # a multiple of the one-pass loop's unroll x block; timed in turns with
    # add_
    print("[train kernels] flat_g_accum", flush=True)
    gs = rand()
    ragged = torch.randn(4 * 31_111, generator=gen, device=dev)
    for what, (acc, x) in (("bert-large layout", (gs, g)),
                           ("ragged length", (ragged, ragged.flip(0)))):
        for gd in (torch.float32, torch.bfloat16):
            xg = x.to(gd)
            if not torch.equal(fs.flat_g_accum(acc.clone(), xg), fs.g_accum_ref(acc.clone(), xg)):
                fail(f"flat_g_accum on the {what} with {gd} g is not bit-identical to its plain "
                     "version")
            print(f"  flat_g_accum on the {what} ({acc.numel()} floats, {gd} g): torch.equal ok",
                  flush=True)
    del ragged, xg
    err9 = 0.0
    t9 = cuda_ms_interleaved({"kernel": lambda: fs.flat_g_accum(gs, g),
                              "lib": lambda: gs.add_(g),
                              "plain": lambda: fs.g_accum_ref(gs, g)})
    b9_ms, b9_by = bound(3 * n * 4, n, "float32")
    print(f"  flat_g_accum (ms, in turns): kernel={t9['kernel']:.6f} add_={t9['lib']:.6f} "
          f"plain={t9['plain']:.6f} bound={b9_ms:.6f} ({b9_by}); "
          f"{b9_ms / t9['kernel'] * 100:.1f} % of the bound (add_ "
          f"{b9_ms / t9['lib'] * 100:.1f} %); kernel / add_ {t9['kernel'] / t9['lib']:.4f}",
          flush=True)
    print(f"  controls on the grid-stride loop: flat_moments_accum {t3:.4f} ms (earlier "
          f"{EARLIER_MS['flat_moments_accum']})", flush=True)
    records["flat_g_accum"] = dict(
        name="flat_g_accum", route="cuda", source="src/repro_torch/kernels/csrc/flat_stats.cu",
        replaces="src/repro/kernels/flat_stats.py:77", max_abs_err=err9, ms=t9["kernel"],
        plain_ms=t9["plain"], bound_ms=b9_ms, bound_by=b9_by, library_ms=t9["lib"])
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
# phase 7b: the norm sums of K5, K7, K16 and K17 over a leaf of 2^30 elements
# ---------------------------------------------------------------------------

# A leaf of 2^23 rows of 128 (131,072 blocks, 4.3 GB a f32 buffer) between
# two small leaves.  The per-leaf sums of u^2 and w^2 that set the LAMB and
# LARS trust ratios are two-level (flat_update.cuh::norm_sums): f32 over a
# thread's 32 elements, f64 across the block and, in block order, across
# the blocks, rounded once to f32.  So each is within NORM_RTOL of an f64
# sum of the same u and w: the last rounding is 2^-24 = 6e-8, the threads'
# f32 sums round unbiased and average out over 2^25 threads.  The first
# design added one f32 atomicAdd per block, which drifts with the block
# count (ROADMAP C3: 3.43e-4 of Σr over 212,992 blocks).
# The small leaves (one block each) are held to NORM_RTOL_SMALL: the f64
# reference of K5's and K7's u rounds otherwise than the kernel's f32 u by a
# few ulps an element, which over a few hundred elements does not average
# out.
NORM_BIG_ROWS = 1 << 23
NORM_RTOL = 1e-7
NORM_RTOL_SMALL = 1e-6
NORM_PAD_BLOCKS = 2  # the padded row shard of K16/K17: the big leaf, the last leaf, 2 pad blocks


def phase_norm_sums(records):
    """K5 (VR-LAMB) and K7 (VR-LARS) over a layout with a leaf of 131,072
    blocks, and K16/K17 on a padded row shard of it (the big leaf, the last
    leaf and NORM_PAD_BLOCKS zero blocks of leaf id 0): each per-leaf Σu²
    and Σw² within NORM_RTOL of an f64 sum of the same u and w, the same
    bits on a repeat from the same state.  K5's u is rebuilt in f64 from its
    m', v' and w; K7 runs at gamma 1 (r = 1, so u = ga + wd w); K16 and K17
    return their u."""
    import torch

    from repro_torch.core.layout import ParamLayout, pad_mask
    from repro_torch.kernels import flat_spmd as fsp
    from repro_torch.kernels import flat_update as fu

    dev = torch.device("cuda")
    layout = ParamLayout(("a", "big", "c"), ((3, 70), (NORM_BIG_ROWS, 128), (5,)))
    n_rows, slots = layout.n_rows, layout.leaf_slots
    big = layout.paths.index("big")
    first = layout.row_offsets[big]
    extra = NORM_PAD_BLOCKS * 64
    print(f"[norm sums] leaves {layout.paths}: big leaf {NORM_BIG_ROWS * 128} elements "
          f"({NORM_BIG_ROWS // 64} blocks), {n_rows * 512 / 1e9:.2f} GB a f32 buffer; K16/K17 on "
          f"rows {first}.. plus {NORM_PAD_BLOCKS} pad blocks", flush=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    mask = pad_mask(layout, dev)

    def buf(fill):
        x = torch.empty((n_rows + extra, 128), device=dev)
        fill(x)
        x[:n_rows].mul_(mask)
        x[n_rows:].zero_()
        return x

    g = buf(lambda x: x.normal_(generator=gen))
    g2 = buf(lambda x: x.uniform_(1.5, 3.0, generator=gen).mul_(g).mul_(g))
    w = buf(lambda x: x.normal_(0.0, 0.02, generator=gen))
    m, v, p = (torch.empty_like(g) for _ in range(3))

    def reset():  # the same m, v, p before every call
        st = torch.Generator(device=dev).manual_seed(5)
        m.copy_(buf(lambda x: x.normal_(0.0, 1e-3, generator=st)))
        v.copy_(buf(lambda x: x.uniform_(1e-7, 1e-6, generator=st)))
        p.copy_(buf(lambda x: x.uniform_(0.1, 1.0, generator=st)))

    hyper = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
    lr, bc1, bc2, bc3 = 1e-3, 0.19, 0.001999, 0.19
    lars = dict(lr=1e-3, gamma=1.0, mu=0.9, wd=0.01, trust=0.001, eps=1e-12)
    meta = layout.device_meta(dev)
    row_ids = meta["row_ids"]
    lids = torch.cat((meta["block_leaf_ids"][first // 64:],
                      torch.zeros(NORM_PAD_BLOCKS, dtype=torch.int32, device=dev)))
    shard_rows = lids.numel() * 64
    shard_ids = torch.cat((row_ids[first:], torch.zeros(extra, dtype=torch.long, device=dev)))
    full = slice(0, n_rows)
    shard = slice(first, first + shard_rows)

    def sums64(ids, rows, fn):
        """(leaf_slots,) f64 per-leaf sums of fn(row slice) (f64 rows) over
        ``rows`` rows in chunks, by the row leaf ids ``ids``."""
        out = torch.zeros(slots, dtype=torch.float64, device=dev)
        for i in range(0, rows, CHECK_ROWS):
            sl = slice(i, min(i + CHECK_ROWS, rows))
            out.index_add_(0, ids[sl], fn(sl).sum(dim=1))
        return out

    def f32(x):  # a constant as the kernel holds it
        return float(np.float32(x))

    def lamb_u(off):  # K5's u from its m', v' and w, in f64
        def fn(sl):
            sl = slice(sl.start + off, sl.stop + off)
            md, vd = m[sl].double(), v[sl].double()
            return ((md / f32(bc1)) / ((vd / f32(bc2)).sqrt() + f32(hyper["eps"]))
                    + f32(hyper["wd"]) * w[sl].double()).square()
        return fn

    def lars_u(sl):  # K7 at gamma 1: u = ga + wd w
        return (g[sl].double() + f32(lars["wd"]) * w[sl].double()).square()

    def w_sq(off):
        return lambda sl: w[sl.start + off: sl.stop + off].double().square()

    def new_k5():  # uncounted launches that return the per-leaf sums
        _, acc = fu._adam_call("flat_vr_lamb", g[full], g[full], g2[full], m[full], v[full],
                               p[full], w[full], (lr, bc1, bc2, bc3), layout, hyper, "float32", 3)
        return acc[1:]

    def new_k7():
        _, acc = fu._lars_call(g[full], g[full], g2[full], m[full], w[full], (lars["lr"], 1.0),
                               layout, lars["mu"], lars["wd"], lars["trust"], lars["eps"])
        return acc[1:]

    inv = meta["inv_sizes"]
    racc = fsp.leaf_r_partials(g[shard], g2[shard], lids, slots, gsnr_eps=1e-12)
    u_out = {}

    def new_k16():
        u, *_, acc = fsp.vr_lamb_compute(g[shard], g[shard], g2[shard], m[shard], v[shard],
                                         p[shard], w[shard], (lr, bc1, bc2, bc3), racc, lids, inv,
                                         **hyper)
        u_out["u"] = u
        return acc

    def new_k17():
        u, acc = fsp.vr_lars_compute(g[shard], g[shard], g2[shard], w[shard], (lars["lr"], 1.0),
                                     racc, lids, inv, wd=lars["wd"], eps=lars["eps"])
        u_out["u"] = u
        return acc

    def u_sq(sl):
        return u_out["u"][sl].double().square()

    cases = {
        "K5 flat_vr_lamb": (new_k5, row_ids, n_rows, lamb_u(0), w_sq(0)),
        "K7 flat_vr_lars (gamma 1)": (new_k7, row_ids, n_rows, lars_u, w_sq(0)),
        "K16 vr_lamb_compute (padded shard)": (new_k16, shard_ids, shard_rows, u_sq, w_sq(first)),
        "K17 vr_lars_compute (padded shard, gamma 1)": (new_k17, shard_ids, shard_rows, u_sq,
                                                         w_sq(first)),
    }
    worst = {}
    for label, (run, ids, rows, u_fn, w_fn) in cases.items():
        reset()
        got = run().clone()
        want = torch.stack((sums64(ids, rows, u_fn), sums64(ids, rows, w_fn)))
        u_out.clear()
        gap = (got.double() - want).abs() / want.abs().clamp(min=1e-300)
        gap_big = float(gap[:, big].max())
        gap_small = float(gap[:, [i for i in range(layout.n_leaves) if i != big]].max())
        print(f"  {label}: big leaf Σu² {float(got[0, big]):.9e} (f64 {float(want[0, big]):.9e}), "
              f"Σw² {float(got[1, big]):.9e} (f64 {float(want[1, big]):.9e}): relative gap "
              f"{gap_big:.3e} (tol {NORM_RTOL}); small leaves {gap_small:.3e} (tol "
              f"{NORM_RTOL_SMALL})", flush=True)
        reset()
        again = run()
        u_out.clear()
        if not torch.equal(got, again):
            fail(f"{label}: the norm sums differ on a repeat from the same state")
        if gap_big > NORM_RTOL or gap_small > NORM_RTOL_SMALL:
            fail(f"{label}: a norm sum is off an f64 sum beyond its tolerance")
        worst[label] = gap_big
        del got, want
    print(f"  norm sums within {NORM_RTOL} of f64 sums, the same bits on a repeat", flush=True)
    for name, label in (("flat_vr_lamb", "K5 flat_vr_lamb"), ("flat_vr_lars", "K7 flat_vr_lars "
                                                               "(gamma 1)"),
                        ("vr_lamb_compute", "K16 vr_lamb_compute (padded shard)"),
                        ("vr_lars_compute", "K17 vr_lars_compute (padded shard, gamma 1)")):
        if name in records:
            records[name]["norm_sums_rel_gap"] = worst[label]
    del g, g2, w, m, v, p, racc, mask
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
# Each bound is about ten times its largest gap.  Later runs of the same
# W = 2 group (PR 19's code and the next, in turns in one call, the same
# card) put VR-Adam's v 3.56e-3 and VR-LARS's update 3.47e-3 apart, the
# same to four digits in both trees: within the bounds, with less room.
# Planted faults at two
# ranks on the same card: with the norm partials not all-reduced the update
# moved by 2.6e-2 (VR-LAMB) and 8.0e-2 (VR-LARS), inside TRAIN_TOL; with
# the per-leaf sum of r not all-reduced, VR-LAMB's update moved by 6.8e-3
# and its m, v, p by 0.15-0.24 (PERF.md).
DP_TOL = {"loss": 1e-4, "grad_norm": 2e-3, "gsnr": 2e-3, "mv": 5e-3, "p": 2e-4, "upd": 5e-3}
# Phase 10c's runs are held against single-card k = 4 runs within DP_TOL
# too.  Under the mesh each microbatch's backward is split over the ranks:
# a rank's weight gradient is rounded to bf16 over its half of the rows and
# the halves are summed in f32.  One backward over all the rows rounds once
# and sits a bf16 rounding away (the first full-width run measured, after
# step 1, the update 1.19e-2, m 9.8e-3, v 1.17e-2, p 1.39e-2 apart; PERF.md),
# so the single-card runs take their loss through rank_split_loss, which
# takes each group in the ranks' halves and rounds as the mesh does.  Then
# (H100 80GB HBM3, 700 W) loss 2.3e-6, grad_norm 2.8e-4, gsnr/* 8.5e-5,
# the update 3.9e-5, m, v, p 8.5e-7 at most.
TRAIN_STEPS = 3


def rel_diff(a, b) -> float:
    import torch

    a, b = a.to("cuda"), b.to("cuda")  # host snapshots come back one pair at a time
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


def run_plan(plan, state, step, batches, want_fused, label, fresh=None, snapshots="cuda",
             after=None, fused=None, w0_on=None, on_step0=None):
    """Steps ``state`` through ``batches`` on one plan, the counts set to 0
    before and read after each step and held against ``want_fused(i)`` on
    the fused plan (``fused``, by default ``plan == "fused"``; 0 everywhere
    on any other run).  Returns (state, metrics per step, the first step's
    update and flat state buffers (on ``snapshots``; the weights before it
    wait on ``w0_on``, by default the same), or what ``on_step0`` makes of
    them, step walls, launches summed over the fused steps).  ``fresh[i]``
    False makes step i stale; ``after(i, state)`` runs after step i and
    its snapshots."""
    import torch

    hist, walls, path_counts, step1 = [], [], {}, {}
    for i, batch in enumerate(batches):
        with_stats = True if fresh is None else fresh[i]
        w0 = state.params.data.to(w0_on or snapshots, copy=True) if i == 0 else None
        reset_counts()
        (state, metrics), ms = host_ms(lambda: step(state, batch, with_stats))
        counts = read_counts()
        on_fused = plan == "fused" if fused is None else fused
        want = want_fused(i) if on_fused else {n_: 0 for n_ in counts}
        if counts != want:
            fail(f"{label} {plan} step {i}: kernel launches {counts} != expected {want}")
        if on_fused:
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
            step1 = {"upd": state.params.data.to(snapshots) - w0.to(snapshots),
                     **{nm: flat_state(state, nm).to(snapshots)
                        for nm in "mvp" if nm in state.opt_state}}
            del w0
            if on_step0 is not None:
                step1 = on_step0(step1)
        if after is not None:
            after(i, state)
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


# Phases 9, 10b, 10c and 13 train bert-large at full width with its depth
# cut to CUT_LAYERS, so that the script keeps well inside its time limit
# (phases 8 and 11 keep the published 24 layers).  At 24 layers 10b and 10c
# took 492 s of the script's ~820 s, and at 6 the script took 958 s once
# phase 16 came in, past 1,200 s on a slower host (H100 80GB HBM3, 700 W;
# PERF.md).  At 2 layers the layout has 10,710 blocks, which 4 row shards
# still pad.
CUT_LAYERS = 2


def cut_train_config(global_batch=256):
    cfg = bert_train_config()
    return cfg.replace(global_batch=global_batch,
                       model=dataclasses.replace(cfg.model, n_layers=CUT_LAYERS))


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
    cats = report_profile("fused train step (profiled)",
                          lambda: step(state, batches[TRAIN_STEPS]), t_prof, top=14)
    check_gemms("fused train step", cats, step_gemms(m, cfg.optimizer.k))
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
                cats = report_profile("fused vmap train step (profiled)",
                                      lambda: step(state, batches[-1]), t_prof, top=14)
                check_gemms("fused vmap train step", cats, step_gemms(m, 1))
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
    cfg = cut_train_config()
    m, k = cfg.model, cfg.optimizer.k
    tokens = cfg.global_batch * cfg.seq_len
    print(f"[train optimizers] {m.name} at full width, depth cut to {m.n_layers} layers, global "
          f"batch {cfg.global_batch}, seq {cfg.seq_len}, k={k}: fresh VR-Adam/LARS/SGD/Momentum steps, stale VR-Adam/LAMB "
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
          f"({b11_by}); a control on the grid-stride loop (earlier "
          f"{EARLIER_MS['flat_pack_square']})", flush=True)
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

    # K13's partials are one f32 sum per leaf, added up in f64 in both
    # versions (the kernel's block partials in block order, the plain
    # version's row sums), the largest ~6.7e8 and the smallest orders of
    # magnitude below it: each is held to its own sum (a leaf not on the
    # shard must read exactly 0)
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

    def reduce_scatter_(self, t):
        return self._timed("reduce_scatter", self.mesh.reduce_scatter_, t)

    def all_gather(self, out, t):
        return self._timed("all_gather", self.mesh.all_gather, out, t)

    def broadcast_(self, t, src=0):
        return self._timed("broadcast", self.mesh.broadcast_, t, src)

    def barrier(self):
        self.mesh.barrier()


def dp_noise_checkpoint(rank, world, mesh, cfg, batch, params, flag_all, barrier, summary,
                        out_dir):
    """10b's additions at W = 2: one data-parallel VR-LAMB step with
    noise_scale=True (rank 0 first runs the single-card k = W step with the
    readings from the same weights and batch), its readings equal on every
    rank and within NOISE_RTOL's bounds of the single-card ones; then the
    row-sharded state saved (gathered; rank 0 writes) and restored into a
    template from another seed, each rank's rows equal (torch.equal, on the
    elements that hold a parameter) to the rows it saved.  Returns the
    walls and the file size."""
    import torch

    from repro_torch.core.layout import pad_mask
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.checkpoint import restore, save

    dev = mesh.device
    label = f"dp W={world} rank {rank} noise step"
    single = None
    if rank == 0:
        rc = plan_config(cfg, "fused", k=world)
        st = init_state(rc, params=params(), device=dev)
        single = noise_of(make_train_step(rc, noise_scale=True, device=dev)[0](st, batch)[1])
        del st
        torch.cuda.empty_cache()
    barrier()
    dc = plan_config(cfg, "fused", gsnr_source="data_axis")
    state = init_state(dc, params=params(), device=dev, mesh=mesh)
    step = make_train_step(dc, device=dev, mesh=mesh, noise_scale=True)[0]
    reset_counts()
    (state, metrics), ms = host_ms(lambda: step(state, batch))
    counts = read_counts()
    if counts != dp_counts(cfg.model.n_layers, "vr_lamb"):
        raise RuntimeError(f"{label}: launches {counts}")
    for k, c in counts.items():
        summary["counts"][k] = summary["counts"].get(k, 0) + c
    got = noise_of(metrics)
    mine = torch.tensor([got[k] for k in NOISE_KEYS], dtype=torch.float64, device=dev)
    first = mine.clone()
    mesh.broadcast_(first)
    if not flag_all(torch.equal(first, mine)):
        raise RuntimeError(f"{label}: the readings differ across the ranks")
    if rank == 0:
        print(f"  dp W={world} VR-LAMB step with noise_scale=True: {ms:.1f} ms; the readings "
              f"are equal on the {world} ranks", flush=True)
        check_noise(f"dp W={world} readings vs single-card k={world}", got, single,
                    batch["tokens"].shape[0] / world, batch["tokens"].shape[0], NOISE_RTOL)
    path = os.path.join(out_dir, "sharded.npz")
    _, save_ms = host_ms(lambda: save(path, state, mesh=mesh))
    size = os.path.getsize(path)
    template = init_state(dc.replace(seed=1), device=dev, mesh=mesh)
    back, restore_ms = host_ms(lambda: restore(path, template))
    del template
    ok = torch.equal(back.params.data, state.params.data) and \
        (back.step, back.opt_state["pt"]) == (state.step, state.opt_state["pt"])
    for nm in "mvp":
        a, b = back.opt_state[nm], state.opt_state[nm]
        live = a.shard.local(pad_mask(a.layout, dev))
        ok = ok and a.shard == b.shard and torch.equal(a.data[live], b.data[live])
    if not flag_all(ok):
        raise RuntimeError(f"dp W={world} rank {rank}: a restored row shard differs from the "
                           "one saved")
    barrier()
    if rank == 0:
        os.remove(path)
        print(f"  dp W={world} sharded checkpoint: {size / 1e9:.3f} GB, saved (gathered) in "
              f"{save_ms / 1e3:.2f} s, restored in {restore_ms / 1e3:.2f} s; every rank's "
              "m, v, p rows torch.equal to the rows it saved", flush=True)
    del state, back, step
    torch.cuda.empty_cache()
    return {"step_ms": ms, "save_ms": save_ms, "restore_ms": restore_ms, "bytes": size}


def dp_counts(n_layers, name, opt=None, fresh=True):
    """Launches of one rank's fused data-parallel step of optimizer ``name``
    under the OptimizerConfig overrides ``opt`` (default: the data-axis
    source).  A fresh data-axis VR step: K1 twice and K2 once per layer
    (one backward), K11 once.  The microbatch source (and every stale step):
    K1 twice and K2 once per layer per microbatch with K3 per microbatch and
    K4 once (stale: K9 per microbatch), or, under "vmap", K1 twice and K2
    once per layer for all k with K10 once (stale: no carry kernel).  A
    fresh VR step adds K13 and the update kernel once, LAMB and LARS the
    trust epilogue once, as does a stale VR-LAMB step.  A baseline: one
    backward over the whole batch.  Every other count 0."""
    opt = {"gsnr_source": "data_axis"} if opt is None else opt
    vr = name.startswith("vr_")
    vmap = opt.get("stats_method") == "vmap"
    if vr and fresh and opt.get("gsnr_source") == "data_axis":
        passes, carry = 1, {"flat_pack_square": 1}
    elif not vr:
        passes, carry = 1, {}
    elif vmap:
        passes, carry = 1, {"flat_vmap_moments": 1} if fresh else {}
    else:
        k = opt["k"]
        passes = k
        carry = {"flat_moments_accum": k, "flat_moments_finalize": 1} if fresh else \
            {"flat_g_accum": k}
    want = fused_counts(n_layers, 1, carry=None, backward_passes=passes)
    want.update(carry)
    if vr and fresh:
        want.update({DP_UPDATE[name]: 1, "leaf_r_partials": 1})
    if (fresh and name in ("vr_lamb", "vr_lars")) or (not fresh and name == "vr_lamb"):
        want["trust_apply"] = 1
    return want


def dp_state(state, name, mesh):
    """Optimizer state ``name`` as a new whole flat f32 buffer: a row shard
    gathered (a collective: every rank calls it), a tree packed."""
    x = state.opt_state[name]
    if getattr(x, "shard", None) is not None:
        return x.shard.gather(x.data, mesh).float().cpu()
    return flat_state(state, name).cpu()


def dp_rank(rank, world, init, out_dir, global_batch, runs):
    """One rank of a data-parallel group on the card (gloo: every rank shares
    card 0).  For each run (label, optimizer, the mesh run's OptimizerConfig
    overrides, the single-card run's, each step's fresh flag, whether the
    single-card loss splits each group over the ranks' rows):
    rank 0 first runs the single-card microbatch steps from the same weights
    on the same batches (its step-1 update and state kept on the host);
    then every rank runs the data-parallel steps, the launch counts held per
    step (``dp_counts``), the params checked bit-identical across the ranks
    after every step, and rank 0 holds the run against the single-card one
    within DP_TOL (compare_plans).  Writes its counts, walls,
    collective walls and peak memory to out_dir."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.accumulate import rank_split_loss
    from repro_torch.core.layout import FlatParams, is_flat
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import init_data_mesh
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.loss import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = TimedMesh(init_data_mesh("gloo", dev, init_method=init, world_size=world, rank=rank))
    cfg = cut_train_config(global_batch)
    m = cfg.model
    label = f"dp W={world} rank {rank}"
    stream = lm_batches(m.vocab_size, global_batch, cfg.seq_len, seed=2)
    batches = [next(stream) for _ in range(max(len(run[4]) for run in runs))]
    tokens = global_batch * cfg.seq_len
    summary = {"counts": {}, "walls": {}, "peaks": {}, "peak_gib": 0.0, "collectives": {}}

    def barrier():
        mesh.mesh.all_reduce_(torch.zeros(1, device=dev))

    def flag_all(ok: bool) -> bool:
        f = torch.tensor([0.0 if ok else 1.0], device=dev)
        return float(mesh.mesh.all_reduce_(f)) == 0.0

    def params():
        return init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)

    for run, name, mesh_opt, single_opt, fresh, split in runs:
        ref = None
        if rank == 0:
            rc = plan_config(cfg, "fused", name=name, **single_opt)
            state = init_state(rc, params=params(), device=dev)
            loss = rank_split_loss(make_loss_fn(rc), world) if split else None
            step = make_train_step(rc, loss, log_gsnr=True, device=dev)[0]
            hist, first = [], {}
            for i, (batch, with_stats) in enumerate(zip(batches, fresh)):
                w0 = state.params.data.clone() if i == 0 else None
                state, metrics = step(state, batch, with_stats)
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
        dc = plan_config(cfg, "fused", name=name, **mesh_opt)
        torch.cuda.reset_peak_memory_stats()
        tree = params()
        own = FlatParams(tree, m.n_groups(), device=dev).data  # this rank's seeded weights
        state = init_state(dc, params=tree, device=dev, mesh=mesh)  # rank 0's, broadcast
        if not flag_all(torch.equal(own, state.params.data)):
            raise RuntimeError(f"{label}: the seeded weights differ across the ranks")
        del own, tree
        if name.startswith("vr_") and not all(
                is_flat(v) and v.shard is not None and v.shard.n_shards == world
                for k, v in state.opt_state.items() if k in ("m", "v", "p")):
            raise RuntimeError(f"{label}: the flat state is not row-sharded")
        step = make_train_step(dc, log_gsnr=True, device=dev, mesh=mesh)[0]
        hist, first, walls = [], {}, []
        for i, (batch, with_stats) in enumerate(zip(batches, fresh)):
            want = dp_counts(m.n_layers, name, mesh_opt, with_stats)
            w0 = state.params.data.clone() if (i == 0 and rank == 0) else None
            reset_counts()
            (state, metrics), ms = host_ms(lambda: step(state, batch, with_stats))
            counts = read_counts()
            if counts != want:
                raise RuntimeError(f"{label} {run} step {i}: launches {counts} != {want}")
            for k, c in counts.items():
                summary["counts"][k] = summary["counts"].get(k, 0) + c
            walls.append(ms)
            copy = state.params.data.clone()
            mesh.broadcast_(copy)
            if not flag_all(torch.equal(copy, state.params.data)):
                raise RuntimeError(f"{label} {run} step {i}: params differ across the ranks")
            del copy
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(list(vals.values()))):
                raise RuntimeError(f"{label} {run} step {i}: non-finite metrics {vals}")
            hist.append(vals)
            if i == 0:  # every rank takes part in the gathers
                gathered = {nm: dp_state(state, nm, mesh) for nm in "mvp"
                            if nm in state.opt_state}
                if rank == 0:
                    first = {"upd": (state.params.data - w0).cpu(), **gathered}
                    del w0
                del gathered
            if rank == 0:
                gsnr = (f" gsnr mean {vals['gsnr/mean']:.5f}" if "gsnr/mean" in vals else
                        " (stale)" if not with_stats else "")
                print(f"  {label} {run} step {i}: {ms:.1f} ms, loss {vals['loss']:.5f} "
                      f"|g| {vals['grad_norm']:.4f} |upd| {vals['update_norm']:.4e}{gsnr}; "
                      f"params bit-identical on {world} ranks; launches "
                      f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        if rank == 0:
            single = f"k{single_opt['k']}"
            compare_plans(f"dp W={world} {run} vs single-card {single}",
                          {"dp": hist, single: ref[0]}, {"dp": first, single: ref[1]},
                          pair=("dp", single), tol=DP_TOL)
        summary["walls"][run] = walls
        summary["peaks"][run] = torch.cuda.max_memory_allocated() / 2**30
        summary["peak_gib"] = max(summary["peak_gib"], summary["peaks"][run])
        del state, step, first, ref
        torch.cuda.empty_cache()
        barrier()
    if world == 2 and any(run[2].get("gsnr_source") == "data_axis" for run in runs):
        summary["noise_ckpt"] = dp_noise_checkpoint(rank, world, mesh, cfg, batches[0], params,
                                                    flag_all, barrier, summary, out_dir)
    summary["collectives"] = mesh.wall
    summary["tokens"] = tokens
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(summary, f)
    mesh.mesh.close()


def dp_axis_runs(world, runs):
    """Phase 10b's runs: the data-axis source (k = W) against single-card
    k = W microbatch steps, every step fresh."""
    return tuple((name, name, {"gsnr_source": "data_axis"}, {"k": world}, (True,) * steps,
                  False) for name, steps in runs)


# (world, global batch, source, runs); a run is (label, optimizer, the mesh
# run's OptimizerConfig overrides, the single-card run's, each step's fresh
# flag, whether the single-card loss splits each group as the ranks do)
# VR-LAMB steps of each 10b and 10c run: two since phase 10d came in (three
# before), to keep the script's wall (PERF.md)
DP_STEPS = 2
DP_GROUPS = (
    (2, 64, "data_axis GSNR (k = 2)",
     dp_axis_runs(2, (("vr_lamb", DP_STEPS), ("vr_adam", 1), ("vr_lars", 1), ("vr_sgd", 1)))),
    (4, 128, "data_axis GSNR (k = 4)", dp_axis_runs(4, (("vr_lamb", DP_STEPS),))),
)
# Phase 10c: the microbatch source at k = 4 (each microbatch spread over the
# ranks), stale steps, the vmap method and a baseline, against the
# single-card runs of the same method at k = 4.
DP_PATHS_K = 4
DP_PATH_GROUPS = (
    (2, 64, f"microbatch GSNR (k = {DP_PATHS_K}, each microbatch over the ranks)", (
        ("vr_lamb", "vr_lamb", {"k": DP_PATHS_K}, {"k": DP_PATHS_K}, (True,) * DP_STEPS,
         True),
        ("vr_adam refresh 2", "vr_adam", {"k": DP_PATHS_K, "gsnr_refresh": 2},
         {"k": DP_PATHS_K, "gsnr_refresh": 2}, (True, False, True), True),
        ("vr_lamb vmap", "vr_lamb", {"k": DP_PATHS_K, "stats_method": "vmap"},
         {"k": DP_PATHS_K, "stats_method": "vmap"}, (True,), True),
        ("lamb", "lamb", {"k": DP_PATHS_K}, {"k": DP_PATHS_K}, (True,), True),
    )),
)
DP_DEADLINE_S = 600.0


def phase_train_dp(records, groups, tag):
    """10b (``DP_GROUPS``): data-parallel bert-large at full width (depth
    CUT_LAYERS) on the
    card, every rank a process sharing the card over gloo (NCCL refuses two
    ranks on one card), data-axis GSNR.  Two ranks at global batch 64 (32
    sequences per rank, phase 8's microbatch): two VR-LAMB steps, then one
    step each of VR-Adam, VR-LARS and VR-SGD, against single-card k=2
    microbatch steps.  Four ranks at global batch 128, whose row shards pad
    the layout (10,710 blocks at 2 layers): two VR-LAMB steps against
    single-card k=4.
    10c (``DP_PATH_GROUPS``): two ranks at global batch 64 with the
    microbatch source at k = 4 (8 sequences per rank per microbatch): two
    VR-LAMB steps, VR-Adam with gsnr_refresh 2 (fresh, stale, fresh), one
    vmap VR-LAMB step and one LAMB step, against the single-card k = 4
    runs, whose loss splits each group over the ranks' rows
    (rank_split_loss)."""
    import tempfile

    from repro_torch.launch.mesh import local_init_method, run_ranks

    cfg = cut_train_config()
    path_counts = {}
    for world, batch, source, runs in groups:
        print(f"[train dp {tag}] {cfg.model.name} at full width, depth cut to "
              f"{cfg.model.n_layers} layers, "
              f"{world} gloo ranks on one card, global batch {batch} ({batch // world} sequences "
              f"per rank), seq {cfg.seq_len}, fused plan, {source}: "
              f"{', '.join(f'{len(run[4])} x {run[0]}' for run in runs)}", flush=True)
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
            peaks = ", ".join(f"{n} {p:.1f}" for n, p in res["peaks"].items())
            print(f"  rank {r}: step walls (ms, host clock) {walls}; peak memory (GiB) "
                  f"{peaks}; collectives (host clock, card synchronized) {coll}", flush=True)
            for k, c in res["counts"].items():
                path_counts[k] = path_counts.get(k, 0) + c
        lamb = [w for res in ranks for w in res["walls"]["vr_lamb"][1:]]
        print(f"  warm VR-LAMB step wall over the ranks: {np.mean(lamb):.1f} ms = "
              f"{ranks[0]['tokens'] / np.mean(lamb) * 1e3:.0f} tokens/s on one card", flush=True)
    add_path(records, "train_dp", path_counts)


# Phase 10d: FSDP+TP of the weights on a (data, model) grid of ranks, bert-
# large at full width (depth CUT_LAYERS), VR-LAMB k = 4 fresh / stale /
# fresh in bf16 and one fresh step in f32, each held against the one-card
# run of its precision split over the data ranks' rows.
GRID_SHAPE = (2, 2)
GRID_BATCH = 64
GRID_FRESH = (True, False, True)
GRID_F32_FRESH = (True,)
GRID_DEADLINE_S = 300.0
# The f32 steps (TF32 off) differ from the one-card run only in the order
# of their sums, so they hold the sharding's arithmetic tightly: every
# step's metrics and the first step's update, m, v and p within DP_TOL,
# whole and leaf by leaf.  The bf16 steps' metrics are held to DP_TOL at
# every step too; their first-step buffers cannot be: the model axis splits
# each row product's sum and sums the column products' input gradients in
# f32 across the ranks (placement.py), which rounds otherwise than one
# card's GEMMs, and the GSNR ratio's leaf means amplify any rounding.  The
# witness, the one-card run without the split (another rounding of the same
# step), shows the size of that rounding.  So the bf16 buffers are held to
# GRID_BF16_TOL, whole and leaf by leaf: a gradient counted M times on one
# leaf moves that leaf's m by M - 1 and v by M^2 - 1, and a per-leaf sum of
# r or of a LAMB norm counted M times moves that leaf's update, however
# small the leaf, where the whole-buffer gap would not show it.  The
# largest worst-leaf gaps read on an H100 80GB HBM3 (700 W), with the TP
# GEMMs in f32 and in bf16, grid or witness: update 4.6e-2 (embed), m
# 1.25e-2, v 1.40e-2 (wq), p 3.1e-2 (embed); each bound is about 2.5 times
# its gap.  There the grid's and the one-card run's worst leaves lie as
# far from the f32 step (6.2e-2, 1.8e-2, 2.0e-2, 3.4e-2), and the f32 grid
# reads 5.4e-4 on its worst leaf (PERF.md).
GRID_BF16_TOL = {"upd": 0.1, "m": 0.03, "v": 0.035, "p": 0.08}
GRID_F32_TOL = {"upd": DP_TOL["upd"], "m": DP_TOL["mv"], "v": DP_TOL["mv"], "p": DP_TOL["p"]}
# Each leaf of the f32 grid is held to DP_TOL's m and v bound: its worst
# leaves read 5.4e-4 (update, wq), 5.4e-6 (v) and 5.6e-5 (p, embed) on the
# H100.
GRID_F32_LEAF_TOL = {nm: DP_TOL["mv"] for nm in GRID_F32_TOL}


def grid_counts(n_layers, k, fresh):
    """Launches of one rank's fused grid VR-LAMB step: K1 twice and K2 once
    per layer per microbatch (the rank's heads), K3 per microbatch and K4
    (stale: K9 per microbatch), K13 and K16 once on a fresh step, the trust
    epilogue once."""
    want = fused_counts(n_layers, k, carry="moments" if fresh else "g")
    if fresh:
        want.update(leaf_r_partials=1, vr_lamb_compute=1)
    want["trust_apply"] = 1
    return want


def grid_rank(rank, init, out_dir):
    """One rank of phase 10d's (2, 2) grid on card 0 (gloo).  Rank 0 first
    runs the one-card steps; then every rank runs the bf16 grid steps and
    the f32 ones (launches held per step), rank 0 holds them (GRID_SHAPE's
    note), and each rank writes its counts, walls, collective walls, held
    elements and peak memory to out_dir."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.accumulate import rank_split_loss
    from repro_torch.core.layout import pad_mask
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.loss import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = init_grid_mesh("gloo", *GRID_SHAPE, dev, init_method=init, rank=rank)
    cfg = plan_config(cut_train_config(GRID_BATCH), "fused", k=DP_PATHS_K, gsnr_refresh=2)
    cfg32 = cfg.replace(parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"))
    m = cfg.model
    label = f"grid {GRID_SHAPE} rank {rank} {mesh.coords}"
    stream = lm_batches(m.vocab_size, GRID_BATCH, cfg.seq_len, seed=2)
    batches = [next(stream) for _ in GRID_FRESH]

    def params():
        return init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)

    def flag_all(ok: bool) -> bool:
        f = torch.tensor([0.0 if ok else 1.0], device=dev)
        return float(mesh.all_reduce_(f)) == 0.0

    def one_card(cfg, loss, fresh_seq):
        """(metrics per step, the first step's update and m, v, p on the
        leaf elements, peak bytes) of the one-card run with ``loss``."""
        state = init_state(cfg, params=params(), device=dev)
        step = make_train_step(cfg, loss, log_gsnr=True, device=dev)[0]
        hist, first = [], {}
        torch.cuda.reset_peak_memory_stats()
        for i, (batch, fresh) in enumerate(zip(batches, fresh_seq)):
            w0 = state.params.data.clone() if i == 0 else None
            state, metrics = step(state, batch, fresh)
            hist.append({k: float(v) for k, v in metrics.items()})
            if i == 0:  # on the leaf elements: the grid's buffers pad otherwise
                live = pad_mask(state.params.layout, dev)
                first = {"upd": torch.where(live, state.params.data - w0, 0.0).cpu(),
                         **{nm: torch.where(live, flat_state(state, nm), 0.0).cpu()
                            for nm in "mvp"}}
                del w0, live
        peak = torch.cuda.max_memory_allocated()
        del state, step
        torch.cuda.empty_cache()
        return hist, first, peak

    ref = witness = ref32 = None
    if rank == 0:  # the one-card runs split over the data ranks' rows, and the witness
        def split(c):
            return rank_split_loss(make_loss_fn(c), GRID_SHAPE[0])

        ref = one_card(cfg, split(cfg), GRID_FRESH)
        witness = one_card(cfg, None, GRID_FRESH)
        ref32 = one_card(cfg32, split(cfg32), GRID_F32_FRESH)
    flag_all(True)  # a barrier

    def grid_run(cfg, fresh_seq, tag, timed):
        """(state, metrics per step, the first step's update and m, v, p
        whole on rank 0, step walls, launches, peak bytes after init) of the
        grid's steps."""
        state = init_state(cfg, params=params(), device=dev, mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gp = state.params
        step = make_train_step(cfg, log_gsnr=True, device=dev, mesh=mesh)[0]
        mesh.timed = timed
        hist, first, walls, counts_all = [], {}, [], {}
        for i, (batch, fresh) in enumerate(zip(batches, fresh_seq)):
            w0 = gp.gather() if i == 0 else None
            reset_counts()
            (state, metrics), ms = host_ms(lambda: step(state, batch, fresh))
            counts = read_counts()
            want = grid_counts(m.n_layers, DP_PATHS_K, fresh)
            if counts != want:
                raise RuntimeError(f"{label} {tag} step {i}: launches {counts} != {want}")
            for k, c in counts.items():
                counts_all[k] = counts_all.get(k, 0) + c
            walls.append(ms)
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(list(vals.values()))):
                raise RuntimeError(f"{label} {tag} step {i}: non-finite metrics {vals}")
            hist.append(vals)
            if i == 0:  # every rank takes part in the gathers
                mesh.timed = False
                upd = (gp.gather() - w0).cpu()
                gathered = {nm: gp.shard.gather(state.opt_state[nm].data).float().cpu()
                            for nm in "mvp"}
                first = {"upd": upd, **gathered} if rank == 0 else {}
                del w0, upd, gathered
                mesh.timed = timed
            if rank == 0:
                gsnr = f" gsnr mean {vals['gsnr/mean']:.5f}" if "gsnr/mean" in vals else \
                    " (stale)"
                print(f"  {label} {tag} step {i}: {ms:.1f} ms, loss {vals['loss']:.5f} "
                      f"|g| {vals['grad_norm']:.4f} |upd| {vals['update_norm']:.4e}{gsnr}; "
                      f"launches { {k: c for k, c in counts.items() if c} }", flush=True)
        mesh.timed = False
        return state, hist, first, walls, counts_all, torch.cuda.max_memory_allocated()

    state, hist, first, walls, counts_all, peak = grid_run(cfg, GRID_FRESH, "bf16", True)
    gp = state.params
    sh, layout = gp.shard, gp.layout
    whole = {"elements": sum(layout.sizes), "rows": layout.n_rows}
    bufs = {"params": gp.data, "grad": gp.grad,
            **{nm: state.opt_state[nm].data for nm in "mvp"}}
    if any(tuple(b.shape) != (sh.rows, 128) for b in bufs.values()) or sh.rows >= whole["rows"]:
        raise RuntimeError(f"{label}: a flat buffer is not the rank's local layout "
                           f"({ {k: tuple(b.shape) for k, b in bufs.items()} }, whole rows "
                           f"{whole['rows']})")
    held = {"param_elements": sh.held, "rows": sh.rows,
            "state_elements": 3 * sh.held, "state_rows": 3 * sh.rows}
    # every replica of a leaf block the same: each rank's gathered whole
    # params (assembled from its own replica column) equal rank 0's
    mine = gp.gather()
    first_rank = mine.clone()
    mesh.broadcast_(first_rank)
    if not flag_all(torch.equal(first_rank, mine)):
        raise RuntimeError(f"{label}: the replicas of a leaf block differ across the ranks")
    del mine, first_rank, state, gp, bufs
    torch.cuda.empty_cache()
    state32, hist32, first32, walls32, _, _ = grid_run(cfg32, GRID_F32_FRESH, "f32", False)
    del state32
    gaps = None
    if rank == 0:
        gaps = {"f32": hold_grid(f"grid {GRID_SHAPE} f32 vs one-card k{DP_PATHS_K} split",
                                 hist32, first32, ref32, layout, GRID_F32_TOL,
                                 GRID_F32_LEAF_TOL),
                "bf16": hold_grid(f"grid {GRID_SHAPE} bf16 vs one-card k{DP_PATHS_K} split",
                                  hist, first, ref, layout, GRID_BF16_TOL, GRID_BF16_TOL,
                                  witness, ref32)}
    summary = {"counts": counts_all, "walls": walls, "walls_f32": walls32, "held": held,
               "whole": whole, "peak_bytes": peak,
               "one_card_peak_bytes": None if ref is None else ref[2],
               "collectives": {f"{kind} {nb}": w for (kind, nb), w in mesh.walls.items()},
               "coords": mesh.coords, "tokens": GRID_BATCH * cfg.seq_len, "gaps": gaps}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(summary, f)
    mesh.close()


def leaf_gaps(a, b, layout):
    """{path: ||a - b|| / ||b||} over each leaf of two whole flat buffers
    (host snapshots, compared on the card)."""
    import torch

    a, b = a.to("cuda"), b.to("cuda")
    return {p: float(torch.linalg.vector_norm(x - y) /
                     torch.linalg.vector_norm(y).clamp_min(1e-30))
            for p, x, y in zip(layout.paths, layout.leaf_views(a.float()),
                               layout.leaf_views(b.float()))}


def hold_grid(label, hist, first, ref, layout, tol, tol_leaf, witness=None, f32=None):
    """Phase 10d's hold (GRID_SHAPE's note): the grid's metrics at every
    step within DP_TOL of the one-card split run ``ref``; its first-step
    update, m, v and p within ``tol`` whole and ``tol_leaf`` leaf by leaf,
    each gap printed beside the witness's (when given) and, on the worst
    leaf, the grid's and ``ref``'s gaps to the one-card f32 run ``f32``
    (when given: which of the two rounds nearer the f32 step).  Returns
    the gaps."""
    out = {}
    for i, (g, r) in enumerate(zip(hist, ref[0])):
        gg = step_gaps(g, r)
        gw = step_gaps(witness[0][i], r) if witness else None
        out[f"step {i}"] = gg
        print(f"  {label} step {i}: " + "; ".join(
            f"{k} {gg[k]:.3e} (" + (f"witness {gw[k]:.3e}, " if gw else "") +
            f"DP_TOL {DP_TOL[k]})" for k in gg), flush=True)
        if any(gg[k] > DP_TOL[k] for k in gg):
            fail(f"{label} step {i}: the grid and one-card runs disagree past DP_TOL")
    for nm in ("upd", "m", "v", "p"):
        whole = rel_diff(first[nm], ref[1][nm])
        per = leaf_gaps(first[nm], ref[1][nm], layout)
        worst = max(per, key=per.get)
        out[nm] = {"whole": whole, "worst_leaf": worst, "leaf": per[worst]}
        note_whole = note_leaf = ""
        if witness:
            per_w = leaf_gaps(witness[1][nm], ref[1][nm], layout)
            out[nm].update(witness=rel_diff(witness[1][nm], ref[1][nm]),
                           leaf_witness=per_w[worst], witness_worst_leaf=max(per_w.values()))
            note_whole = f" (witness {out[nm]['witness']:.4e})"
            note_leaf = (f" (witness {per_w[worst]:.4e}; the witness's worst leaf "
                         f"{max(per_w.values()):.4e})")
        if f32:
            to32 = (leaf_gaps(first[nm], f32[1][nm], layout)[worst],
                    leaf_gaps(ref[1][nm], f32[1][nm], layout)[worst])
            out[nm].update(leaf_grid_to_f32=to32[0], leaf_one_card_to_f32=to32[1])
            note_leaf += (f"; that leaf from the one-card f32 step: grid {to32[0]:.4e}, "
                          f"one-card {to32[1]:.4e}")
        print(f"  {label} after step 0: ||{nm}_grid - {nm}_one-card|| / ||{nm}_one-card|| = "
              f"{whole:.4e}{note_whole}; worst leaf {worst} {per[worst]:.4e}{note_leaf}; tol "
              f"{tol[nm]} whole, {tol_leaf[nm]} a leaf", flush=True)
        if whole > tol[nm] or per[worst] > tol_leaf[nm]:
            fail(f"{label}: after step 0, {nm} of the grid and one-card runs disagree past "
                 f"{tol[nm]} whole or {tol_leaf[nm]} on a leaf")
    return out


def phase_train_grid(records):
    """10d: FSDP+TP of bert-large's weights on a (2, 2) grid (module
    docstring)."""
    import tempfile

    from repro_torch.launch.mesh import local_init_method, run_ranks

    cfg = cut_train_config(GRID_BATCH)
    d, mm = GRID_SHAPE
    print(f"[train grid 10d] {cfg.model.name} at full width, depth cut to {cfg.model.n_layers} "
          f"layers, a ({d}, {mm}) (data, model) grid of {d * mm} gloo ranks on one card, "
          f"global batch {GRID_BATCH}, seq {cfg.seq_len}, fused plan, VR-LAMB k = {DP_PATHS_K} "
          f"{'/'.join('fresh' if f else 'stale' for f in GRID_FRESH)} in bf16, then "
          f"{'/'.join('fresh' if f else 'stale' for f in GRID_F32_FRESH)} in f32", flush=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        run_ranks(grid_rank, d * mm, args=(local_init_method(), out),
                  deadline_s=GRID_DEADLINE_S)
    except Exception as e:  # a rank failed, died or hung: the phase fails
        fail(f"grid of {d * mm} ranks: {type(e).__name__}: {e}")
    ranks = []
    for r in range(d * mm):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out)
    print(f"  group wall {time.perf_counter() - t0:.1f} s (spawn, init, the one-card run and "
          "the checks included)", flush=True)
    path_counts = {}
    for r, res in enumerate(ranks):
        h, w = res["held"], res["whole"]
        coll = "; ".join(f"{k} B: {v[0]:.1f} ms over {v[1]} calls" for k, v in
                         sorted(res["collectives"].items(), key=lambda kv: -kv[1][0]))
        print(f"  rank {r} {res['coords']}: holds {h['param_elements']:,} param elements of "
              f"{w['elements']:,} ({h['param_elements'] / w['elements']:.4f}), flat rows "
              f"{h['rows']:,} of {w['rows']:,}; m, v, p {h['state_elements']:,} elements "
              f"({h['state_rows']:,} rows) against {3 * w['elements']:,} whole; peak "
              f"{res['peak_bytes'] / 2**30:.3f} GiB after init (the whole layout in f32: "
              f"{w['rows'] * 128 * 4 / 2**30:.3f} GiB"
              + (f"; rank 0's one-card run peaked at {res['one_card_peak_bytes'] / 2**30:.3f} GiB"
                 if res["one_card_peak_bytes"] else "") + ")", flush=True)
        print(f"  rank {r}: launches over the three steps (each step held to grid_counts) "
              f"{ {k: c for k, c in res['counts'].items() if c} }", flush=True)
        print(f"  rank {r}: bf16 step walls (ms, host clock) "
              f"{', '.join(f'{x:.1f}' for x in res['walls'])} (f32: "
              f"{', '.join(f'{x:.1f}' for x in res['walls_f32'])}); collectives (host clock, "
              f"card synchronized; the three bf16 steps) {coll}", flush=True)
        for k, c in res["counts"].items():
            path_counts[k] = path_counts.get(k, 0) + c
    warm = [x for res in ranks for x in res["walls"][1:]]
    print(f"  warm grid step wall over the ranks: {np.mean(warm):.1f} ms = "
          f"{ranks[0]['tokens'] / np.mean(warm) * 1e3:.0f} tokens/s on one card (gloo through "
          "the host: no claim of speed)", flush=True)
    add_path(records, "train_grid", path_counts)


# ---------------------------------------------------------------------------
# phase 12: the per-leaf kernels (K18-K23) and their per-leaf step
# ---------------------------------------------------------------------------

# The per-leaf VR steps (per_leaf_vr_scale, per_leaf_vr_adam_update,
# per_leaf_vr_lamb_update, per_leaf_vr_lars_update) are in
# tests/torch_per_leaf_oracle.py, shared with tests/test_torch_per_leaf.py.

# Stated tolerances of phase 12: K18-K21 against their plain versions rtol
# 1e-4 with atol 1e-4 of the largest magnitude (the prepass kernel sums the
# mean of r in another order than the plain op, within TOL_PREPASS; the
# kernels' norm sums are f32 atomics over block partials, the plain sums
# pairwise); K22 as K3 (Sigma g exact, Sigma g^2
# within one FMA rounding), K23 as K4 (exact).  The per-leaf steps against
# K5-K8's flat step from the same inputs: rtol 1e-4 with atol 1e-4 of the
# largest magnitude (per-leaf sums in another order).
TOL_LEAF = 1e-4
LARGEST_LEAF = (24, 1024, 4096)  # bert-large's stacked MLP input weight
# The prepass kernel against inv_mean_r: each sums up to 1e8 positive terms
# in another order (the kernel per thread in f32, then in f64 across
# threads and blocks; the plain version torch's f32 tree), rtol 1e-5.
TOL_PREPASS = dict(atol=0.0, rtol=1e-5)


@contextlib.contextmanager
def fixed_prepass(inv):
    """The per-leaf wrappers with their prepass replaced by a tensor already
    on the card, to time the step kernels alone."""
    from repro_torch.kernels import vr_adam as va
    from repro_torch.kernels import vr_lamb as vl
    from repro_torch.kernels import vr_update as vu

    mods = (vu, va, vl)
    saved = [m.leaf_inv_mean for m in mods]
    for m in mods:
        m.leaf_inv_mean = lambda *_: inv
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.leaf_inv_mean = fn


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
    """12: (a) the prepass and K18-K23 against their plain versions at
    bert-large's largest stacked leaf, with times beside bounds; (b) the
    per-leaf path over bert-large's full layout: the k-microbatch moment
    carry leaf by leaf (K22 per leaf per microbatch, K23 per leaf) against
    the flat carry (K3, K4), then the per-leaf VR-scale, VR-Adam, VR-LAMB
    and VR-LARS steps against K8, K6, K5 and K7's flat step from the same
    inputs, and the device kernels of one call of each."""
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
    # the GSNR prepass: against inv_mean_r on this leaf, a ragged leaf, a bf16
    # g and an all-zero leaf (exactly 1 / f32(1e-30)), the same bits twice
    zeros = torch.zeros(4099, device=dev)
    ragged = rand((4099,), 1e-2)
    pre_cases = (("largest leaf", x["g"], x["g2"]),
                 ("ragged leaf (4099)", ragged, ragged * ragged + rand((4099,), 1e-4, True)),
                 ("bf16 g", x["g"].to(torch.bfloat16), x["g2"]),
                 ("all-zero leaf (4099)", zeros, zeros))
    err_pre = 0.0
    for what, a, b in pre_cases:
        got, again = vu.leaf_inv_mean(a, b, 1e-12), vu.leaf_inv_mean(a, b, 1e-12)
        if not torch.equal(got, again):
            fail(f"leaf_inv_mean on the {what}: two launches differ ({float(got)!r}, "
                 f"{float(again)!r})")
        want = vu.inv_mean_r(a, b, 1e-12)
        if what.startswith("all-zero"):
            if float(got) != float(want) or float(got) != float(np.float32(1) / np.float32(1e-30)):
                fail(f"leaf_inv_mean on the all-zero leaf: {float(got)!r}, want 1e30")
            print(f"  leaf_inv_mean on the {what}: {float(got)!r} == the plain version's, "
                  "repeat bit-identical ok", flush=True)
            continue
        err_pre = max(err_pre, check_close(f"leaf_inv_mean on the {what} (repeat bit-identical)",
                                           got, want, TOL_PREPASS))
    del zeros, ragged, pre_cases, got, again, want
    t_pre = cuda_ms_interleaved({"kernel": lambda: vu.leaf_inv_mean(x["g"], x["g2"], 1e-12),
                                 "plain": lambda: vu.inv_mean_r(x["g"], x["g2"], 1e-12)})
    b_pre, b_pre_by = bound(2 * n * 4, 6 * n, "float32")
    print(f"  leaf_inv_mean (ms, in turns): kernel={t_pre['kernel']:.6f} "
          f"plain={t_pre['plain']:.6f} bound={b_pre:.6f} ({b_pre_by}); "
          f"{b_pre / t_pre['kernel'] * 100:.1f} % of the bound; no single PyTorch call computes "
          "it", flush=True)
    records["leaf_inv_mean"] = dict(
        name="leaf_inv_mean", route="cuda", source="src/repro_torch/kernels/csrc/vr_leaf.cu",
        replaces="src/repro/kernels/vr_update.py:73", max_abs_err=err_pre, ms=t_pre["kernel"],
        plain_ms=t_pre["plain"], bound_ms=b_pre, bound_by=b_pre_by, library_ms=None,
        shape=list(shape))
    inv = vu.leaf_inv_mean(x["g"], x["g2"], 1e-12)
    for name, (kernel, plain, args, kw, n_in, n_out, line) in cases.items():
        got, want = kernel(*args, **kw), plain(*args, **kw)
        err = max(check_close(f"{name} out {i}", a, b, tol_leaf(b))
                  for i, (a, b) in enumerate(zip(got, want)))
        del got, want
        t_k = cuda_ms(lambda: kernel(*args, **kw))
        with fixed_prepass(inv):  # the step kernel alone, inv_mean already on the card
            t_alone = cuda_ms(lambda: kernel(*args, **kw))
        t_p = cuda_ms(lambda: plain(*args, **kw), iters=5)
        b_ms, b_by = bound((n_in + n_out) * n * 4, 40 * n, "float32")
        print(f"  {name} (ms): kernel with its prepass kernel={t_k:.4f} (alone {t_alone:.4f}) "
              f"plain={t_p:.4f} bound={b_ms:.4f} ({b_by}); {b_ms / t_k * 100:.1f} % of the "
              f"bound ({b_ms / t_alone * 100:.1f} % alone); no single PyTorch call computes it",
              flush=True)
        records[name] = dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/vr_leaf.cu", replaces=line,
                             max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, kernel_alone_ms=t_alone, shape=list(shape))
    # K20/K21's sums of u^2 and w^2 over the leaf's blocks (the grid's cap,
    # 16 an SM): two-level f64, within NORM_RTOL of an f64 sum of the same u
    # and w, the same bits on a repeat
    for name in ("vr_lamb_inner", "vr_lars_inner"):
        kernel, _, args, kw, *_ = cases[name]
        out, again = kernel(*args, **kw), kernel(*args, **kw)
        want = (out[0].double().square().sum(), x["w"].double().square().sum())
        gaps = [abs(float(a) - float(b)) / float(b) for a, b in zip(out[-2:], want)]
        same = all(torch.equal(a, b) for a, b in zip(out[-2:], again[-2:]))
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(-(-n // (4 * 128)), vu.STEP_BLOCKS_PER_SM * n_sm)
        print(f"  {name} norm sums over {grid} blocks: sum(u^2) {gaps[0]:.3e}, sum(w^2) "
              f"{gaps[1]:.3e} off an f64 sum (tol "
              f"{NORM_RTOL}); repeat bit-identical: {same}", flush=True)
        if max(gaps) > NORM_RTOL or not same:
            fail(f"{name}: norm sums {gaps} off f64 (tol {NORM_RTOL}) or differ on a repeat")
        records[name]["norm_sums_rel_gap"] = max(gaps)
        del out, again
    del cases, inv
    carry = (gs.moments_init(x["g"]), gs.moments_init(x["g"]))
    plain = tuple(t.clone() for t in carry)
    for i in range(3):
        gs.moments_accum(*carry, x["g"] * (i + 1))
        gs.moments_accum_ref(*plain, x["g"] * (i + 1))
    err22 = max(check_close("moments_accum g_sum", carry[0], plain[0], TOL_EXACT),
                check_close("moments_accum g2_sum", carry[1], plain[1], TOL_CARRY))
    if not all(torch.equal(a, b) for a, b in zip(
            gs.moments_finalize(carry[0].clone(), carry[1].clone(), 3, shape),
            gs.moments_finalize_ref(carry[0].clone(), carry[1].clone(), 3, shape))):  # one carry
        fail("moments_finalize is not bit-identical to its plain version")
    print("  moments_finalize: torch.equal ok", flush=True)
    err23 = 0.0
    a, b, gl = carry[0], carry[1], x["g"]
    t22 = (cuda_ms(lambda: gs.moments_accum(a, b, gl)),
           cuda_ms(lambda: gs.moments_accum_ref(a, b, gl)),
           cuda_ms(lambda: (a.view(-1).add_(gl.view(-1)), b.view(-1).addcmul_(gl.view(-1),
                                                                             gl.view(-1)))))
    t23 = cuda_ms_interleaved({"kernel": lambda: gs.moments_finalize(a, b, 8, shape),
                               "plain": lambda: gs.moments_finalize_ref(a, b, 8, shape),
                               "lib": lambda: (a.mul_(0.125), b.mul_(0.125))})
    t23 = (t23["kernel"], t23["plain"], t23["lib"])
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
                    "leaf_inv_mean", "moments_accum", "moments_finalize")
    want_counts = {nm: layout.n_leaves for nm in leaf_kernels}
    want_counts["moments_accum"] = k * layout.n_leaves
    want_counts["leaf_inv_mean"] = 4 * layout.n_leaves  # one before each VR step kernel
    got_counts = {nm: counts[nm] for nm in leaf_kernels}
    if got_counts != want_counts:
        fail(f"per-leaf path launches {got_counts} != {want_counts}")
    print(f"  per-leaf path launches: {got_counts}", flush=True)
    add_path(records, "per_leaf", got_counts)

    # each per-leaf VR wrapper call on an aligned f32 leaf (the largest, a
    # view of whole rows: no padded copy) launches two device kernels, the
    # prepass and its step kernel (K20 and K21 also zero their two norm sums
    # with a memset); counted in a CUDA graph of the call, since
    # torch.profiler saw no device events this late in the script (PERF.md)
    big = max(range(layout.n_leaves), key=lambda i: lg[i].numel())
    one = dict(g=lg[big], g2=lsq[big], ga=lga[big], w=lw[big], m=views(m0)[big],
               v=views(v0)[big], p=views(p0)[big])
    bc = (0.19, 0.002, 0.19)
    adam_kw = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, gamma=0.1, gsnr_eps=1e-12)
    calls = {
        "vr_scale": lambda: vu.vr_scale(one["g"], one["g2"], 0.1, 1e-12, g_apply=one["ga"]),
        "vr_adam_inner": lambda: va.vr_adam_inner(one["g"], one["g2"], one["m"], one["v"],
                                                  one["p"], *bc, g_apply=one["ga"], **adam_kw),
        "vr_lamb_inner": lambda: vl.vr_lamb_inner(one["g"], one["ga"], one["g2"], one["m"],
                                                  one["v"], one["p"], one["w"], *bc, wd=0.01,
                                                  **adam_kw),
        "vr_lars_inner": lambda: vl.vr_lars_inner(one["g"], one["ga"], one["g2"], one["w"],
                                                  wd=1e-4, gamma=0.1, eps=1e-12),
    }
    for name, call in calls.items():
        n_kernels, n_memsets = graph_kernels(call)
        print(f"  {name} on the {tuple(one['g'].shape)} f32 leaf: {n_kernels} device kernels, "
              f"{n_memsets} memsets per call", flush=True)
        if n_kernels != 2:
            fail(f"{name}: {n_kernels} device kernels per call on an aligned f32 leaf, want 2")
    n_plain, _ = graph_kernels(lambda: vu.inv_mean_r(one["g"], one["g2"], 1e-12))
    print(f"  the plain prepass (inv_mean_r) on that leaf, counted the same way: {n_plain} "
          "device kernels", flush=True)
    del one, calls
    del stats, grads, w, m0, v0, p0, mask
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the resumable, autoscaled training path at full width
# ---------------------------------------------------------------------------

# Phase 13(a)'s token caches: Markov documents over bert-large's vocabulary
# (uint16), stored lengths 17-256 (16-255 trained tokens).  The training
# cache packs into ~1,600 rows of 128 (so (c) crosses an epoch boundary),
# the eval cache into 116 rows (four batches of 32, the last padded).
TRAIN_CACHE_TOKENS = 205_000
EVAL_CACHE_TOKENS = 14_000
AUTOSCALE_ROWS = 32  # the loader's batch_rows: k x 32 rows a step
AUTOSCALE_STEPS = 8
AUTOSCALE_POLICY = dict(k_min=2, k_max=8, warmup_steps=2, cooldown=1, hysteresis=1.25,
                        ema_beta=0.8)
# Stated tolerances of the noise readings.  Against an f64 sum of the same
# carry, g2_small and g2_big (f32 sums of ~3.6e8 terms) within rtol 1e-5;
# between two plans or two programs, the sums within NOISE_RTOL: TRAIN_TOL
# lets the plans' grad_norm differ by 2e-3 relative, and a squared norm by
# twice that.  tr_sigma and g2, differences of the two sums, are held within
# rtol (g2_small + g2_big) times their largest coefficient, 1 / (1/B_s -
# 1/B_b) and B_b / (B_b - B_s); b_simple within what those two give
# (tests/test_torch_noise_scale.py::check_estimate, the same rule).
SAME_CARRY_RTOL = 1e-5
NOISE_RTOL = 4e-3
NOISE_KEYS = ("g2_small", "g2_big", "tr_sigma", "g2", "b_simple")


def make_token_caches(vocab: int):
    """Phase 13(a)'s training and eval caches in a new directory under
    build/; returns their paths and write walls (the caller removes
    ``dir``).  Written before phase 7, which packs rows from the training
    cache."""
    import tempfile

    from repro_torch.data import markov_documents, write_token_cache

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = {"dir": tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))}
    for name, total, stream in (("train", TRAIN_CACHE_TOKENS, 1), ("eval", EVAL_CACHE_TOKENS, 2)):
        out[name] = os.path.join(out["dir"], name)
        t0 = time.perf_counter()
        write_token_cache(markov_documents(vocab, total, 16, 255, seed=0, stream_seed=stream),
                          out[name], dtype=np.uint16, vocab=vocab)
        out[f"{name}_write_s"] = time.perf_counter() - t0
    return out


def packed_tail_rows(data, rows: int, pad_rows: int = 4):
    """The last ``rows - pad_rows`` rows of epoch 0 of the training cache's
    pack index, padded with ``pad_rows`` whole pad rows."""
    from repro_torch.data import IndexedPackedDataset, gather_rows

    ds = IndexedPackedDataset(data["train"], 128, rows, seed=0)
    pack = ds.pack_for(0)
    return gather_rows(pack, ds.cache.tokens, pack.n_rows - (rows - pad_rows), pack.n_rows,
                       pad_to=rows)


def check_noise(label, got, want, b_small, b_big, rtol):
    """The readings ``got`` against ``want`` (dicts of floats over
    NOISE_KEYS): the sums within ``rtol``, tr_sigma, g2 and b_simple within
    the bounds that gives (see NOISE_RTOL).  Returns the gaps."""
    scale = rtol * (abs(want["g2_small"]) + abs(want["g2_big"]))
    lim = {"g2_small": rtol * abs(want["g2_small"]), "g2_big": rtol * abs(want["g2_big"]),
           "tr_sigma": scale / (1.0 / b_small - 1.0 / b_big),
           "g2": scale * b_big / (b_big - b_small)}
    lim["b_simple"] = (lim["tr_sigma"] + abs(want["b_simple"]) * lim["g2"]) / \
        (abs(want["g2"]) - lim["g2"])
    gaps = {k: abs(got[k] - want[k]) for k in NOISE_KEYS}
    print(f"  {label}: " + ", ".join(f"{k} {got[k]:.6e} vs {want[k]:.6e} (|diff| {gaps[k]:.2e},"
                                     f" bound {lim[k]:.2e})" for k in NOISE_KEYS), flush=True)
    for k in NOISE_KEYS:
        if not (np.isfinite(got[k]) and gaps[k] <= lim[k]):
            fail(f"{label}: {k} {got[k]} vs {want[k]} outside {lim[k]}")
    return gaps


def noise_of(metrics) -> dict:
    return {k: float(metrics[f"noise/{k}"]) for k in NOISE_KEYS}


def clone_state(state):
    """A copy of a TrainState whose buffers share nothing with ``state``
    (the steps update params and the flat state in place)."""
    from repro_torch.core.layout import FlatBuffer, FlatParams, is_flat

    p = state.params
    opt = {k: FlatBuffer(v.data.clone(), v.layout, v.shard) if is_flat(v) else v
           for k, v in state.opt_state.items()}
    return state._replace(params=FlatParams.from_flat(p.data.clone(), p.layout, p.n_groups),
                          opt_state=opt)


def state_gaps(a, b) -> dict:
    """Relative gaps of params and of m/v/p between two states, over the
    elements that hold a parameter (a checkpoint does not store a flat
    buffer's padding, where p is nonzero)."""
    from repro_torch.core.layout import pad_mask

    live = pad_mask(a.params.layout, a.params.device)
    out = {"params": rel_diff(a.params.data, b.params.data)}
    out.update({nm: rel_diff(flat_state(a, nm)[live], flat_state(b, nm)[live]) for nm in "mvp"})
    return out


@contextlib.contextmanager
def counted_steps(n_layers, log):
    """Every train step made by ``make_train_step`` while active (the
    autoscale loop builds its own, one per k) runs with the counts set to 0
    just before it and read just after; they must be a fused VR-LAMB step's
    at that step's k.  Appends (k, counts, peak GiB, step ms on the host
    clock, synchronized) to ``log``."""
    import torch

    from repro_torch.train import trainer

    real = trainer.make_train_step

    def make(cfg_k, *args, **kwargs):
        fn, opt = real(cfg_k, *args, **kwargs)
        k = cfg_k.optimizer.k

        def step(state, batch, with_stats=True):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out, ms = host_ms(lambda: fn(state, batch, with_stats))
            counts = read_counts()
            want = fused_counts(n_layers, k, "flat_vr_lamb")
            if counts != want:
                fail(f"autoscale step at k={k}: launches {counts} != expected {want}")
            log.append((k, counts, torch.cuda.max_memory_allocated() / 2**30, ms))
            return out

        return step, opt

    trainer.make_train_step = make
    try:
        yield
    finally:
        trainer.make_train_step = real


def phase_autoscale(records, data):
    """13: bert-large at full width (depth CUT_LAYERS) on packed rows from a
    token cache: (a) the data path, (b) one fresh k=8 step's noise readings,
    (c) autoscale_train_loop, (d) a whole-state checkpoint and its restore,
    (e) eval_loss over an eval cache on both plans."""
    import torch

    from repro_torch.core import noise_scale as ns
    from repro_torch.core.accumulate import grad_stats
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data import DataState, IndexedPackedDataset
    from repro_torch.data.check import check_cache
    from repro_torch.models import init_params
    from repro_torch.train import eval_loss, init_state, make_train_step
    from repro_torch.train.autoscale import AutoscalePolicy, autoscale_train_loop
    from repro_torch.train.checkpoint import restore, save
    from repro_torch.train.loss import make_loss_fn

    dev = torch.device("cuda")
    base = plan_config(cut_train_config(), "fused", base_batch=256, lr_scale_rule="sqrt")
    m, seq = base.model, base.seq_len

    def at_k(k, plan="fused"):
        return plan_config(base, plan, k=k).replace(global_batch=k * AUTOSCALE_ROWS)

    path_counts = {}

    def add(counts):
        for name, c in counts.items():
            path_counts[name] = path_counts.get(name, 0) + c

    # ---- (a) the data path ----------------------------------------------------
    print(f"[autoscale] {m.name} at full width, depth cut to {m.n_layers} layers: d_model {m.d_model}, vocab "
          f"{m.vocab_size}; VR-LAMB, seq {seq}, {base.parallel.compute_dtype} compute, lr "
          f"{base.optimizer.lr} at base_batch 256 (sqrt rule), packed rows from a token cache",
          flush=True)
    for name in ("train", "eval"):
        findings = check_cache(data[name], seq_len=seq, epochs=(0, 1), vocab=m.vocab_size)
        if findings:
            fail(f"check_cache on the {name} cache: {findings}")
    ds0 = IndexedPackedDataset(data["train"], seq, AUTOSCALE_ROWS, seed=0)
    t0 = time.perf_counter()
    pack = ds0.pack_for(0)
    index_s = time.perf_counter() - t0
    n_rows = pack.n_rows
    print(f"  train cache: {ds0.cache.n_docs} documents, {ds0.cache.n_tokens} tokens (uint16), "
          f"written in {data['train_write_s']:.2f} s; epoch 0's pack index {n_rows} rows of "
          f"{seq}, pack efficiency {pack.pack_efficiency:.4f}, built in {index_s:.3f} s; "
          "check_cache: no findings", flush=True)
    probe = IndexedPackedDataset(data["train"], seq, 256, seed=0)
    probe.pack_for(0)
    gather_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        probe.next_batch(256)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
    it = IndexedPackedDataset(data["train"], seq, 256, seed=0).iter_batches(
        device=True, prefetch_size=2)
    next(it)
    n_fetch = 12
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fetched = [next(it) for _ in range(n_fetch)]
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    it.close()
    check = IndexedPackedDataset(data["train"], seq, 256, seed=0)
    check.next_batch(256)
    for i, got in enumerate(fetched):
        want = check.next_batch(256)
        if not all(torch.equal(got[k].cpu(), torch.from_numpy(want[k])) for k in want):
            fail(f"device prefetch: batch {i} differs from next_batch's")
    del fetched
    print(f"  next_batch(256) host ms (median of 5): {np.median(gather_ms):.3f}; "
          f"iter_batches(device=True, prefetch_size=2): {n_fetch / fetch_s:.1f} batches/s of "
          f"256 x {seq} ({n_fetch} batches, each equal to next_batch's on the host)", flush=True)

    # ---- (b) the noise readings of one fresh k=8 step ---------------------------
    k8 = at_k(8)
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = IndexedPackedDataset(data["train"], seq, 256, seed=0).next_batch()
    b_small, b_big = 256 / 8, 256
    state = init_state(k8, params=params, device=dev)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    _, _, carry = grad_stats(make_loss_fn(k8), state.params, tb, 8, backend=k8.parallel.backend)
    exact = ns.estimate_from_terms(carry.sq_mean.data.double().sum(),
                                   carry.mean.data.double().square().sum(), b_small, b_big)
    exact = {k: float(getattr(exact, k)) for k in NOISE_KEYS}
    t_read = cuda_ms(lambda: ns.estimate(carry, b_small=b_small, b_big=b_big))
    read_bound, _ = bound(nbytes(carry.mean.data, carry.sq_mean.data), 0, "float32")
    del carry, tb
    torch.cuda.empty_cache()
    step = make_train_step(k8, noise_scale=True, device=dev)[0]
    reset_counts()
    (state, metrics), step_ms = host_ms(lambda: step(state, batch))
    counts = read_counts()
    want = fused_counts(m.n_layers, 8, "flat_vr_lamb")
    if counts != want:
        fail(f"noise_scale step: launches {counts} != expected {want}")
    add(counts)
    fused = noise_of(metrics)
    print(f"  one fresh k=8 step with noise_scale=True on 256 packed rows: {step_ms:.1f} ms, "
          f"launches {({k: c for k, c in counts.items() if c})} (those of phase 8's step); lr "
          f"{metrics['lr']:.6e}", flush=True)
    check_noise("readings vs an f64 sum of the same carry", fused, exact, b_small, b_big,
                SAME_CARRY_RTOL)
    print(f"  the readings (ns.estimate on the carry): {t_read:.4f} ms device; bound "
          f"{read_bound:.4f} ms (mean and sq_mean read once)", flush=True)
    rcfg = at_k(8, "reference")
    rstate = init_state(rcfg, params=params, device=dev)
    _, rmetrics = make_train_step(rcfg, noise_scale=True, device=dev)[0](rstate, batch)
    check_noise("fused vs reference plan", fused, noise_of(rmetrics), b_small, b_big, NOISE_RTOL)
    del rstate, rmetrics, state, step, metrics
    torch.cuda.empty_cache()

    # ---- (c) autoscale_train_loop on the fused plan ---------------------------
    policy = AutoscalePolicy(**AUTOSCALE_POLICY)
    start = DataState.make(0, n_rows - 3 * 2 * AUTOSCALE_ROWS, 0)  # crosses epoch 0's end
    ds = IndexedPackedDataset(data["train"], seq, AUTOSCALE_ROWS, state=start)
    state = init_state(at_k(policy.k_min), params=params, device=dev)
    del params
    log = []
    print(f"[autoscale] autoscale_train_loop: {AUTOSCALE_STEPS} steps from k0 {policy.k_min}, "
          f"batch_rows {AUTOSCALE_ROWS}, {AUTOSCALE_POLICY}; the cursor starts at row "
          f"{int(start.row)} of epoch 0's {n_rows}", flush=True)
    with counted_steps(m.n_layers, log):
        state, hist = autoscale_train_loop(at_k(policy.k_min), ds, AUTOSCALE_STEPS,
                                           policy=policy, state=state)
        if len({r["k"] for r in hist}) == 1:  # the policy held k: change it by hand
            k_next = policy.k_max if hist[0]["k"] != policy.k_max else policy.k_min
            print(f"  the policy held k at {hist[0]['k']}: two more steps from the returned "
                  f"state with cfg.optimizer.k = {k_next}", flush=True)
            state, more = autoscale_train_loop(at_k(k_next), ds, 2, policy=policy, state=state)
            hist += [dict(r, step=r["step"] + len(hist)) for r in more]
    for _, c, _, _ in log:
        add(c)
    if len(log) != len(hist):
        fail(f"autoscale: {len(log)} counted steps for {len(hist)} history rows")
    unscaled = make_schedule(dataclasses.replace(base.optimizer, base_batch=0))
    for i, (row, (k, _, gib, ms)) in enumerate(zip(hist, log)):
        eff = row["effective_batch"]
        lr = unscaled(i) * np.sqrt(eff / 256)  # the schedule at step i, on the sqrt rule
        print(f"  step {i}: k {row['k']} effective batch {eff} epoch {row['epoch']} loss "
              f"{row['loss']:.5f} lr {row['lr']:.6e} (sqrt rule {lr:.6e}) b_simple "
              f"{row['b_simple']:.4f} ema {row['b_simple_ema']:.4f} pack "
              f"{row.get('pack_efficiency', float('nan')):.4f}; step {ms:.1f} ms = "
              f"{eff * seq / ms * 1e3:.0f} tokens/s; peak {gib:.2f} GiB", flush=True)
        if abs(row["lr"] - lr) > 1e-5 * lr:
            fail(f"autoscale step {i}: lr {row['lr']} is not the sqrt rule's {lr}")
        if i and not np.isfinite(row["b_simple"]):
            fail(f"autoscale step {i}: b_simple {row['b_simple']} is not finite")
    ks = [r["k"] for r in hist]
    if hist[0]["epoch"] == hist[-1]["epoch"] or len(set(ks)) < 2 or state.k != ks[-1]:
        fail(f"autoscale: epochs {[r['epoch'] for r in hist]}, k {ks}, state.k {state.k}: the "
             "run must cross an epoch boundary and change k")
    peaks = {}
    for k, _, gib, _ in log:
        peaks.setdefault(k, []).append(gib)
    print(f"  k trajectory {ks}; b_simple_ema {[round(r['b_simple_ema'], 3) for r in hist]}; "
          "peak memory per step by k (GiB): "
          + "; ".join(f"k={k}: {', '.join(f'{g:.2f}' for g in v)}" for k, v in peaks.items()),
          flush=True)

    k_now = state.k
    probe_batch = IndexedPackedDataset(data["train"], seq, AUTOSCALE_ROWS,
                                       state=ds.state).next_batch(k_now * AUTOSCALE_ROWS)
    pstep = make_train_step(at_k(k_now), noise_scale=True, device=dev)[0]
    pstate = clone_state(state)
    _, p_ms = host_ms(lambda: pstep(pstate, probe_batch))
    report_profile(f"autoscaled packed step at k={k_now} (profiled)",
                   lambda: pstep(pstate, probe_batch), p_ms, top=8)
    del pstate, pstep
    torch.cuda.empty_cache()

    # ---- (d) whole-state checkpoint --------------------------------------------
    path = os.path.join(data["dir"], "state.npz")
    cursor = ds.state
    _, save_ms = host_ms(lambda: save(path, {"state": state, "data": cursor}))
    size = os.path.getsize(path)
    template = {"state": init_state(at_k(k_now).replace(seed=1), device=dev)._replace(k=0),
                "data": DataState.make()}
    back, restore_ms = host_ms(lambda: restore(path, template))
    del template
    os.remove(path)
    rs, rcur = back["state"], back["data"]
    same = torch.equal(rs.params.data, state.params.data) and all(
        torch.equal(a, b) for nm in "mvp"
        for a, b in zip(_leaves(rs.opt_state[nm].unpack()), _leaves(state.opt_state[nm].unpack())))
    same = same and (rs.step, rs.k, rs.opt_state["pt"]) == (state.step, state.k,
                                                            state.opt_state["pt"])
    same = same and tuple(map(int, rcur)) == tuple(map(int, cursor))
    nb_rows = k_now * AUTOSCALE_ROWS
    nxt = IndexedPackedDataset(data["train"], seq, AUTOSCALE_ROWS, state=cursor).next_batch(nb_rows)
    rnxt = IndexedPackedDataset(data["train"], seq, AUTOSCALE_ROWS, state=rcur).next_batch(nb_rows)
    same = same and all(np.array_equal(nxt[k], rnxt[k]) for k in nxt)
    if not same:
        fail("checkpoint: the restored state or cursor differs from the one saved")
    print(f"[autoscale] checkpoint of the state (step {state.step}, k {k_now}) and the cursor "
          f"{tuple(map(int, cursor))}: {size / 1e9:.3f} GB written in {save_ms / 1e3:.2f} s, "
          f"restored in {restore_ms / 1e3:.2f} s into a template from seed 1; params, every m, "
          "v, p leaf, step, k, pt and the cursor torch.equal / equal; the next batch "
          "byte-identical", flush=True)
    stepk = make_train_step(at_k(k_now), device=dev)[0]
    runs = {}
    for name, st in (("in memory", clone_state(state)), ("restored", rs),
                     ("in memory again", clone_state(state))):
        new, met = stepk(st, nxt)
        runs[name] = (new, {k: float(v) for k, v in met.items()})
        del new, st
    del state, rs, back
    torch.cuda.empty_cache()
    (a, ma), (r, mr), (b2, mb) = runs["in memory"], runs["restored"], runs["in memory again"]
    del runs
    for label, (x, mx) in (("restored", (r, mr)), ("in memory again", (b2, mb))):
        d_loss = abs(mx["loss"] - ma["loss"]) / abs(ma["loss"])
        d_gn = abs(mx["grad_norm"] - ma["grad_norm"]) / abs(ma["grad_norm"])
        gaps = state_gaps(x, a)
        print(f"  one step from the {label} state vs from the in-memory one: loss {d_loss:.3e}, "
              f"grad_norm {d_gn:.3e}, " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()),
              flush=True)
        if d_loss > TRAIN_TOL["loss"] or d_gn > TRAIN_TOL["grad_norm"] or \
                gaps["params"] > TRAIN_TOL["upd"] or max(gaps["m"], gaps["v"]) > TRAIN_TOL["mv"] \
                or gaps["p"] > TRAIN_TOL["p"]:
            fail(f"checkpoint: the step from the {label} state leaves TRAIN_TOL")
    del r, b2
    torch.cuda.empty_cache()

    # ---- (e) eval_loss over the eval cache on both plans ---------------------
    eval_ds = IndexedPackedDataset(data["eval"], seq, AUTOSCALE_ROWS, seed=0)
    n_eval = len(list(eval_ds.epoch_batches()))
    ev = {}
    for plan in ("fused", "reference"):
        ecfg = at_k(k_now, plan)
        reset_counts()
        ev[plan], ms = host_ms(lambda: eval_loss(ecfg, None, a.params, eval_ds))
        counts = read_counts()
        if plan == "fused":
            add(counts)
        print(f"  eval_loss on the {plan} plan: {ev[plan]:.6f} over {n_eval} batches of "
              f"{AUTOSCALE_ROWS} rows ({eval_ds.pack_for(0).n_rows} rows, the last batch "
              f"padded), {ms:.1f} ms; launches {({k: c for k, c in counts.items() if c})}",
              flush=True)
    d_eval = abs(ev["fused"] - ev["reference"]) / abs(ev["reference"])
    if n_eval != 4 or not np.isfinite(ev["fused"]) or d_eval > TRAIN_TOL["loss"]:
        fail(f"eval_loss: {n_eval} batches, fused {ev['fused']} vs reference {ev['reference']}")
    add_path(records, "autoscale", path_counts)
    print(f"  eval loss rel diff fused vs reference {d_eval:.3e} (tol {TRAIN_TOL['loss']})",
          flush=True)
    del a
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: DLRM, the paper's Table 5 workload, VR-SGD at batch 512k
# ---------------------------------------------------------------------------

# The one cut of DLRM's published widths (configs/dlrm.py::config): 2^19 rows
# per table, not 2^20.  At 2^20 the (26, 2^20, 128) tables leaf is 13.96 GB
# per f32 buffer, and a fused VR-SGD step holds six to seven such buffers
# (params, gradient, the two moment carries, K8's sg and r, -lr sg): 84-98 GB
# against the card's 80 GB.
DLRM_TABLE_SIZE = 2 ** 19
DLRM_BATCH = 524_288  # Table 5's largest global batch (512k): 65,536 rows per microbatch
DLRM_STEPS = 3
DLRM_EVAL = 8_192  # held-out samples for the AUC, drawn as benchmarks/bench_dlrm_proxy.py does
# The fused plan against the reference plan, and each mixed plan and the
# whole-batch loss of the SGD step against the fused plan, from the same
# params and batches.  Both plans run the same f32 GEMMs (TF32 off), so the
# gradients agree but for rounding; the moments differ by K3's FMA (one
# rounding of g^2), and the GSNR leaf means by the order of K8's f64 block
# combine against the plain f64 row sums.  Compared: the loss (relative),
# and each leaf's change over the step against the other run's relative to
# its norm: the worst MLP leaf ("mlp") and the tables leaf over the rows the
# batch read ("touched").  run() fails when the tables changed on any row
# the batch did not read, so "touched" covers the whole leaf.  Bounds, set
# from the first full-width run on an H100 80GB HBM3 (700 W), which measured
# the loss equal to the bit at every step.  Step 0 (DLRM_TOL_STEP0, which
# also holds both mixed plans, compared at step 0 alone): the MLP leaves'
# change 1.08e-5, the tables' 0, in the fused-vs-reference run and in both
# mixed plans; "mlp" is 9.3 times that gap and the tables get the same
# 1e-4.  Steps 1-2 (DLRM_TOL): the GSNR ratio amplifies step 0's rounding
# gap, to 8.89e-4 on the MLP leaves (a 256-element bias, step 1) and 3.56e-3
# on the tables (step 2, a row read once moves by rounding quanta of its
# weights); both bounds are 5.6 times the gap (PERF.md).  The loss, whose
# gap is 0, gets 1e-6 (17 f32 ulps at 0.69) at every step.
DLRM_TOL_STEP0 = {"loss": 1e-6, "mlp": 1e-4, "touched": 1e-4}
DLRM_TOL = {"loss": 1e-6, "mlp": 5e-3, "touched": 2e-2}


def event_ms(fn, iters: int = 5) -> float:
    """Median device time of fn() between two CUDA events, after one warm-up
    call: for launches of several ms over buffers too large to hold a CUDA
    graph's private copies."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def dlrm_touched(cfg, batch):
    """The flat rows of the tables leaf a batch reads, sorted: feature f's id
    i is row f * T + i (an embedding row of 128 is one flat row)."""
    import torch

    offs = torch.arange(cfg.n_sparse_features, device=batch["sparse"].device) * cfg.table_size
    return torch.unique(offs[None, :] + batch["sparse"].long())


def compare_dlrm(label, got, want):
    """Each step's record of run ``got`` against run ``want``, step 0 within
    DLRM_TOL_STEP0 and later steps within DLRM_TOL; returns the largest
    gaps."""
    worst = {key: 0.0 for key in DLRM_TOL}
    for i, (a, b) in enumerate(zip(got, want)):
        tol = DLRM_TOL_STEP0 if i == 0 else DLRM_TOL
        mlp = {p: rel_diff(a["mlp"][p], b["mlp"][p]) for p in b["mlp"]}
        p_max = max(mlp, key=mlp.get)
        gaps = {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]), "mlp": mlp[p_max],
                "touched": rel_diff(a["touched"], b["touched"])}
        print(f"  {label} step {i}: |loss rel diff| {gaps['loss']:.3e}; change rel diff: worst "
              f"MLP leaf ({p_max}) {gaps['mlp']:.3e}, tables leaf (on the rows read, the only "
              f"rows it changed on) {gaps['touched']:.3e} (tol {tol})", flush=True)
        for key, gap in gaps.items():
            worst[key] = max(worst[key], gap)
            if not gap <= tol[key]:
                fail(f"{label} step {i}: {key} gap {gap:.3e} > {tol[key]}")
    return worst


def dlrm_kernels(records, box, batch, k, loss_fn):
    """K3, K4 and K8 at DLRM's flat layout (13.6 M rows), each against its
    plain version, timed beside its bound: K3 and K4 on one microbatch's
    gradient, K8 on a step's moments and on moments whose GSNR ratio is
    mostly unclipped (g2 = g^2 (1 + u), u ~ U(0.5, 2): r_raw = 1/u), where
    r shows each version's per-leaf mean of r, held against an f64 sum.
    ``box`` holds the only reference to the stepped FlatParams, which is
    freed before K8; launches made here count on no path."""
    import torch

    from repro_torch.backend import Backend
    from repro_torch.core.accumulate import grad_stats, split_batch
    from repro_torch.core.layout import pad_mask
    from repro_torch.kernels import flat_stats as fs
    from repro_torch.kernels import flat_update as fu

    flat = box.pop()
    layout, dev = flat.layout, flat.device
    n = layout.n_rows * 128
    print(f"[dlrm kernels] K3, K4, K8 at DLRM's flat layout: {layout.n_rows} rows "
          f"({layout.n_blocks} blocks), {n * 4 / 1e9:.3f} GB per f32 buffer", flush=True)
    flat.zero_grad()
    loss_fn(flat.tree, {name: x[0] for name, x in split_batch(batch, k).items()})[0].backward()
    g = flat.grad
    a1, b1 = g.clone(), g * g
    a2, b2 = a1.clone(), b1.clone()
    fs.flat_moments_accum(a1, b1, g)
    fs.moments_accum_ref(a2, b2, g)
    err3 = max(check_close("K3 g_sum", a1, a2, TOL_CARRY),
               check_close("K3 g2_sum", b1, b2, TOL_CARRY))
    t3 = event_ms(lambda: fs.flat_moments_accum(a1, b1, g))
    t3_plain = event_ms(lambda: fs.moments_accum_ref(a2, b2, g))
    t3_lib = event_ms(lambda: (a2.add_(g), b2.addcmul_(g, g)))
    b3 = bound(5 * n * 4, 3 * n, "float32")
    a2.copy_(a1)  # the timings above accumulated each pair a different number of times
    b2.copy_(b1)
    fs.flat_moments_finalize(a1, b1, k)
    fs.moments_finalize_ref(a2, b2, k)
    if not (torch.equal(a1, a2) and torch.equal(b1, b2)):
        fail("K4 at DLRM's layout is not bit-identical to its plain version")
    print("  K4: torch.equal ok", flush=True)
    t4 = event_ms(lambda: fs.flat_moments_finalize(a1, b1, k))
    t4_plain = event_ms(lambda: fs.moments_finalize_ref(a2, b2, k))
    t4_lib = event_ms(lambda: (a2.mul_(0.125), b2.mul_(0.125)))
    b4 = bound(4 * n * 4, 2 * n, "float32")
    del a1, b1, a2, b2, g
    print(f"  K3 (ms): kernel={t3:.4f} plain={t3_plain:.4f} add_+addcmul_={t3_lib:.4f} "
          f"bound={b3[0]:.4f} ({b3[1]}); K4 (ms): kernel={t4:.4f} plain={t4_plain:.4f} "
          f"2x mul_={t4_lib:.4f} bound={b4[0]:.4f} ({b4[1]})", flush=True)
    records["flat_moments_accum"]["dlrm"] = dict(
        max_abs_err=err3, ms=t3, plain_ms=t3_plain, bound_ms=b3[0], bound_by=b3[1],
        library_ms=t3_lib)
    records["flat_moments_finalize"]["dlrm"] = dict(
        max_abs_err=0.0, ms=t4, plain_ms=t4_plain, bound_ms=b4[0], bound_by=b4[1],
        library_ms=t4_lib)

    # K8 on a step's moments (VR-SGD: ga is the mean itself)
    stats = grad_stats(loss_fn, flat, batch, k, backend=Backend.all_fused())[2]
    del flat
    torch.cuda.empty_cache()
    g, g2 = stats.mean.data, stats.sq_mean.data
    del stats
    meta_bytes = 4 * layout.n_blocks + 4 * layout.leaf_slots
    # ga is g here, so the function reads g and g2 and writes sg and r: 4 buffers
    b8 = bound(4 * n * 4 + meta_bytes, 10 * n, "float32")
    ti = layout.paths.index("tables")
    rows = slice(layout.row_offsets[ti], layout.row_offsets[ti] + layout.leaf_rows[ti])

    def tables_inv_mean(r, wr):
        """1 / mean(r_raw) over the tables leaf: an f64 sum of the plain
        version's r_raw, beside what the kernel's and the plain version's r
        imply (r / r_raw, median over the unclipped elements of the leaf's
        first CHECK_ROWS rows); returns their relative errors."""
        total = 0.0
        for i in range(rows.start, rows.stop, CHECK_ROWS):
            j = min(i + CHECK_ROWS, rows.stop)
            total += float(fu.raw_r(g[i:j], g2[i:j], 1e-12).double().sum())
        inv64 = layout.sizes[ti] / total
        probe = slice(rows.start, rows.start + CHECK_ROWS)
        raw = fu.raw_r(g[probe], g2[probe], 1e-12)
        inv = {}
        for who, rr in (("kernel", r[probe]), ("plain", wr[probe])):
            free = (rr > 0.1) & (rr < 1.0)
            inv[who] = float((rr[free] / raw[free]).double().median())
        rel = {who: abs(x - inv64) / inv64 for who, x in inv.items()}
        print(f"  K8 tables leaf 1/mean(r_raw) ({layout.sizes[ti]} elements, "
              f"{layout.leaf_rows[ti] // layout.block_rows} blocks): f64 sum {inv64:.9f}; from "
              f"r: kernel {inv['kernel']:.9f} (rel err {rel['kernel']:.2e}), plain "
              f"{inv['plain']:.9f} (rel err {rel['plain']:.2e})", flush=True)
        return rel

    def k8(what, probe=False):  # phase 7's tolerance
        sg, r = fu.flat_vr_scale(g, g, g2, layout, gamma=0.1, eps=1e-12)
        wsg, wr = fu.flat_vr_scale_ref(g, g, g2, layout, gamma=0.1, eps=1e-12)
        rel = tables_inv_mean(r, wr) if probe else None
        tol_sg = dict(atol=1e-4 * max(float(wsg[i: i + CHECK_ROWS].abs().max())
                                      for i in range(0, wsg.shape[0], CHECK_ROWS)), rtol=1e-4)
        err = max(check_close(f"K8 sg ({what})", sg, wsg, tol_sg),
                  check_close(f"K8 r ({what})", r, wr, dict(atol=1e-4, rtol=1e-4)))
        return err, rel

    err8, _ = k8("a step's moments")
    t8 = event_ms(lambda: fu.flat_vr_scale(g, g, g2, layout, gamma=0.1, eps=1e-12))
    t8_plain = event_ms(lambda: fu.flat_vr_scale_ref(g, g, g2, layout, gamma=0.1, eps=1e-12),
                        iters=3)
    # the per-leaf sum of r over 212,992 blocks, with r mostly unclipped
    gen = torch.Generator(device=dev).manual_seed(14)
    g.normal_(generator=gen).mul_(pad_mask(layout, dev))
    g2.uniform_(1.5, 3.0, generator=gen).mul_(g).mul_(g)
    err_u, rel = k8("unclipped r", probe=True)
    del g, g2
    torch.cuda.empty_cache()
    print(f"  K8 (ms): kernel (2 launches)={t8:.4f} plain={t8_plain:.4f} bound={b8[0]:.4f} "
          f"({b8[1]}); no single PyTorch call computes it", flush=True)
    records["flat_vr_scale"]["dlrm"] = dict(
        max_abs_err=max(err8, err_u), ms=t8, plain_ms=t8_plain, bound_ms=b8[0], bound_by=b8[1],
        library_ms=None, tables_inv_mean_rel_err=rel)


def phase_dlrm(records):
    """14: DLRM at its published widths (table_size cut to 2^19) trained with
    Table 11's VR-SGD at Table 5's 512k batch through train/driver.py."""
    import torch

    from repro_torch.backend import Backend
    from repro_torch.configs import dlrm as dc
    from repro_torch.core.layout import FlatParams
    from repro_torch.data import CTRModel, ctr_batches
    from repro_torch.models import dlrm
    from repro_torch.train.driver import auc, train_optimizer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = dc.config()
    cfg = dataclasses.replace(full, table_size=DLRM_TABLE_SIZE)
    opt = dc.optimizer(DLRM_BATCH)
    print(f"[dlrm] {full.name} ({full.citation}): {cfg.n_dense_features} dense and "
          f"{cfg.n_sparse_features} sparse features, embedding {cfg.embedding_dim}, bottom MLP "
          f"{cfg.bottom_mlp}, top MLP {cfg.top_mlp}, f32; {opt.name} k={opt.k} gamma {opt.gamma} "
          f"lr {opt.lr:.4f} ({opt.schedule}, warm-up {opt.warmup_steps}; Table 11); global batch "
          f"{DLRM_BATCH} (Table 5's 512k), {DLRM_BATCH // opt.k} rows per microbatch", flush=True)
    full_gb = full.n_sparse_features * full.table_size * full.embedding_dim * 4 / 1e9
    print(f"  cut: table_size {cfg.table_size} (2^19), not {full.table_size} (2^20): at 2^20 the "
          f"tables leaf is {full_gb:.2f} GB per f32 buffer and a fused VR-SGD step holds 6-7 "
          f"such buffers (params, gradient, two moment carries, K8's sg and r, -lr sg), "
          f"{6 * full_gb:.0f}-{7 * full_gb:.0f} GB, against the 80 GB card", flush=True)
    t0 = time.perf_counter()
    stream = ctr_batches(DLRM_BATCH, cfg.table_size, cfg.n_sparse_features, seed=0)
    host = [next(stream) for _ in range(DLRM_STEPS + 1)]
    test = CTRModel(table_size=cfg.table_size, n_sparse=cfg.n_sparse_features,
                    seed=0).sample(DLRM_EVAL, np.random.RandomState(123))
    t_data = time.perf_counter() - t0
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    touched = [dlrm_touched(cfg, b) for b in batches]
    base_loss = dlrm.loss_fn(cfg)
    calls = [0]

    def loss_fn(p, b):  # one call is one forward and one backward
        calls[0] += 1
        return base_loss(p, b)

    def make_params():
        gen = torch.Generator(device=dev).manual_seed(0)
        return FlatParams(dlrm.init_params(cfg, gen, device=dev), 1, device=dev)

    flat = make_params()
    layout = flat.layout
    ti = layout.paths.index("tables")
    tab = slice(layout.row_offsets[ti], layout.row_offsets[ti] + layout.leaf_rows[ti])
    buf_gb = layout.n_rows * 128 * 4 / 1e9
    n_mlp = sum(layout.sizes) - layout.sizes[ti]
    print(f"  params: {layout.sizes[ti]} table elements ({layout.leaf_rows[ti]} flat rows, "
          f"{layout.leaf_rows[ti] // layout.block_rows} blocks of {layout.block_rows}) + {n_mlp} "
          f"MLP elements in {layout.n_leaves} leaves, {layout.n_rows} rows, {buf_gb:.2f} GB per "
          f"f32 buffer; batches made on the host in {t_data:.1f} s; the steps read "
          f"{', '.join(str(t.numel()) for t in touched[:DLRM_STEPS])} table rows", flush=True)
    print(f"  memory reckoned from the code: fused step ~5 buffers in the backward "
          f"({5 * buf_gb:.0f} GB: params, gradient, g_sum, g2_sum, the embedding's dense "
          f"gradient), ~7 in the update ({7 * buf_gb:.0f} GB: + sg, r, -lr sg); reference plan "
          f"~8 ({8 * buf_gb:.0f} GB: the tree GSNR chain's temporaries)", flush=True)
    prev = torch.empty((layout.leaf_rows[ti], 128), dtype=torch.float32, pin_memory=True)

    def run(label, bk, opt_cfg, steps, want, want_calls, params=None):
        """``steps`` steps through train_optimizer from the seeded params;
        after each, the launches and loss_fn calls held against ``want`` and
        ``want_calls``, and the step's record on the host: loss, each MLP
        leaf's change, the tables leaf's change on the rows the batch read
        and its nonzero rows (which must lie among them).  Returns (params,
        driver result, records, launches summed)."""
        flat = params if params is not None else make_params()
        tables = flat.data[tab]
        mlp = [(p, v) for i, (p, v) in enumerate(zip(layout.paths, layout.leaf_views(flat.data)))
               if i != ti]
        before = {"mlp": [v.clone() for _, v in mlp]}
        prev.copy_(tables)
        recs, peaks, path_counts = [], [], {}

        def after(i, params, loss):
            counts = read_counts()
            if counts != want or calls[0] != want_calls:
                fail(f"dlrm {label} step {i}: launches {counts} and {calls[0]} loss_fn calls, "
                     f"want {want} and {want_calls}")
            for name, c in counts.items():
                path_counts[name] = path_counts.get(name, 0) + c
            peaks.append(torch.cuda.max_memory_allocated())
            delta = prev.to(dev).neg_().add_(tables)
            rows = (delta != 0).any(dim=1).nonzero()[:, 0]
            if not bool(torch.isin(rows, touched[i]).all()):
                fail(f"dlrm {label} step {i}: the tables changed on rows the batch did not read")
            recs.append({"loss": loss, "n_changed": rows.numel(),
                         "touched": delta[touched[i]].cpu(),
                         "mlp": {p: (v - v0).cpu() for (p, v), v0 in zip(mlp, before["mlp"])}})
            del delta
            prev.copy_(tables)
            before["mlp"] = [v.clone() for _, v in mlp]
            reset_counts()
            calls[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        calls[0] = 0
        out = train_optimizer(loss_fn, flat, batches[:steps], opt_cfg, steps, backend=bk,
                              device=dev, callback=after)
        print(f"  {label}: {held / 2**30:.1f} GiB held on the card before the first step "
              f"(the params, their gradient, the batches)", flush=True)
        for i, (rec, s, peak) in enumerate(zip(recs, out["step_s"], peaks)):
            print(f"  {label} step {i}: {s * 1e3:.1f} ms ({DLRM_BATCH / s:.0f} samples/s), loss "
                  f"{rec['loss']:.6f}, peak {peak / 2**30:.1f} GiB; tables changed on "
                  f"{rec['n_changed']} rows, all read by the batch", flush=True)
        return flat, out, recs, path_counts

    fused = Backend.all_fused()
    want_fused = fused_counts(0, opt.k, "flat_vr_scale")
    flat, out, rec_fused, counts = run("fused", fused, opt, DLRM_STEPS, want_fused, opt.k, flat)
    add_path(records, "dlrm", counts)
    walls = [s * 1e3 for s in out["step_s"]]
    del out
    warm = float(np.mean(walls[1:]))
    print(f"  fused step wall (host clock, synchronized): {', '.join(f'{w:.1f}' for w in walls)} "
          f"ms; warm mean {warm:.1f} ms = {DLRM_BATCH / warm * 1e3:.0f} samples/s; launches per "
          f"step {({k_: c for k_, c in want_fused.items() if c})}", flush=True)
    with torch.no_grad():
        scores = dlrm.forward(cfg, flat.tree, *(torch.from_numpy(test[k_]).to(dev)
                                                for k_ in ("dense", "sparse")))
    print(f"  AUC of the stepped params on {DLRM_EVAL} held-out samples: "
          f"{auc(test['label'], scores.float().cpu().numpy()):.4f} (after {DLRM_STEPS} warm-up "
          "steps: printed, gates nothing)", flush=True)
    def one_more():  # returns nothing: the driver's result holds the params
        train_optimizer(base_loss, flat, batches[DLRM_STEPS:], opt, 1, backend=fused, device=dev)

    t_prof = host_ms(one_more)[1]
    report_profile("dlrm fused VR-SGD step (profiled)", one_more, t_prof, top=12)
    box = [flat]
    del flat, one_more, scores
    dlrm_kernels(records, box, batches[0], opt.k, base_loss)
    torch.cuda.empty_cache()

    zero = {name: 0 for name in counters()}
    _, _, rec_ref, _ = run("reference", Backend.all_reference(), opt, DLRM_STEPS, zero, opt.k)
    torch.cuda.empty_cache()
    gaps = compare_dlrm("fused vs reference", rec_fused, rec_ref)
    print(f"  largest gaps over the {DLRM_STEPS} steps: {gaps}", flush=True)
    sgd = dataclasses.replace(opt, name="sgd")
    _, _, rec_sgd, _ = run("sgd baseline", fused, sgd, 1, zero, 1)
    torch.cuda.empty_cache()
    d_loss = abs(rec_sgd[0]["loss"] - rec_fused[0]["loss"]) / abs(rec_fused[0]["loss"])
    print(f"  sgd step's loss over the whole batch against the fused step's mean over "
          f"{opt.k} microbatches: |rel diff| {d_loss:.3e} (tol {DLRM_TOL['loss']})", flush=True)
    if not d_loss <= DLRM_TOL["loss"]:
        fail("dlrm: the whole-batch loss differs from the microbatches' mean")
    for label, bk, want in (
            ("stats fused / optimizer reference", Backend(stats="fused", optimizer="reference"),
             fused_counts(0, opt.k)),
            ("stats reference / optimizer fused", Backend(stats="reference", optimizer="fused"),
             fused_counts(0, opt.k, "flat_vr_scale", carry=None))):
        _, _, rec, _ = run(label, bk, opt, 1, want, opt.k)
        torch.cuda.empty_cache()
        compare_dlrm(f"{label} vs fused", rec, rec_fused[:1])
    del prev
    print(f"  dlrm phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 15: the paper-table benchmarks
# ---------------------------------------------------------------------------

# (a) runs the five ported benches (repro_torch/benchmarks) with the
# reference's fast protocol on the card (the full protocol is
# ``python -m repro_torch.benchmarks.run``); (b) one point of each on the
# fused and the reference plan, each step's launches held.  Stated
# tolerances between the plans: the f32 benches (linreg, cifar, dlrm) take
# the same math in another summation order, and the GSNR ratio amplifies the
# rounding (tests/test_torch_benchmarks.py holds the same points against
# the reference within 1e-5..1e-4): each step's loss within 1e-4 relative;
# the test MSE too, the accuracy within 2 of the 4,000 test samples, the
# AUC within 1e-3.  The transformer points compute in bf16, where the plans'
# attention rounds otherwise (phase 5: logits 0.015 apart on average): the
# eval losses within 2e-3 relative.
BENCH_TOL = {"f32": 1e-4, "bf16": 2e-3, "acc_samples": 2, "auc": 1e-3}
BENCH_POINT_STEPS = 5


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_benches(records):
    import torch

    from repro_torch.backend import Backend
    from repro_torch.benchmarks import (bench_bert_proxy, bench_cifar_proxy, bench_dlrm_proxy,
                                        bench_gengap, bench_linreg, common)

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = torch.device("cuda")
    # K1 (with the LSE) and K2 at the microbatch shapes of the two
    # transformer benches: gengap's head dim 32 runs the CUDA-core kernels
    # (the wgmma tiles take 64 and 128), bert proxy's 64 the tensor cores
    rng = np.random.default_rng(8)
    for tag, (b, s, h, d) in (("gengap", (16, 32, 4, 32)), ("bert proxy", (16, 32, 4, 64))):
        q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
                       .to(dev, torch.bfloat16) for _ in range(4))
        label = f"{tag} microbatch B{b} S{s} H{h} D{d} bf16 causal"
        e1, e2, args, _ = check_attention_bwd(label, q, k, v, do, None, True)
        t1 = cuda_ms(lambda: fa.flash_attention(q, k, v, *args[6:], causal=True, with_lse=True))
        t2 = cuda_ms(lambda: fab.flash_attention_bwd(*args, causal=True))
        print(f"  {label}: K1 with_lse {t1:.4f} ms, K2 {t2:.4f} ms", flush=True)
        for name, e, t in (("flash_attention_fwd", e1, t1), ("flash_attention_bwd", e2, t2)):
            r = records[name]
            r["max_abs_err"] = max(r["max_abs_err"], e)
            r.setdefault("bench_shapes", {})[tag] = dict(shape=label, max_abs_err=e, ms=t)
    record = os.path.join(ROOT, "build", "smoke_bench_autoscale.json")
    print("[benches] the five ported paper-table benches, fast protocol, on the card "
          "(name,us_per_call,derived)", flush=True)
    t0 = time.perf_counter()
    n_rows = len(common.ROWS)
    for mod in (bench_linreg, bench_cifar_proxy, bench_bert_proxy, bench_gengap,
                bench_dlrm_proxy):
        kw = {"record_path": record} if mod is bench_bert_proxy else {}
        mod.main(fast=True, device=dev, **kw)
    with open(record) as f:
        ab = json.load(f)
    os.remove(record)
    if ab["autoscaled"]["k_changes"] < 1 or ab["plan"]["optimizer"] != "fused":
        fail(f"the autoscale A/B: {ab['autoscaled']['k_changes']} k changes, plan {ab['plan']}")
    print(f"  {len(common.ROWS) - n_rows} rows in {time.perf_counter() - t0:.1f} s; the A/B's "
          f"k trajectory {ab['autoscaled']['k_trajectory']}", flush=True)

    fused, plain = Backend.all_fused(), Backend.all_reference()
    path_counts = {}

    def held(want):
        """A train_optimizer callback: each step's launches equal ``want``
        (the counts set to 0 before the run and after each step)."""
        def cb(i, params, loss):
            got = read_counts()
            if got != want:
                fail(f"bench point step {i}: launches {got} != {want}")
            for k_, c in got.items():
                path_counts[k_] = path_counts.get(k_, 0) + c
            reset_counts()
        return cb

    def carry(k, update):
        want = {name: 0 for name in counters()}
        want.update(flat_moments_accum=k, flat_moments_finalize=1, **{update: 1})
        return want

    def both(label, run, want):
        reset_counts()
        got = run(fused, held(want))
        ref = run(plain, None)
        gap = max(rel(a, b) for a, b in zip(got["losses"], ref["losses"]))
        print(f"  {label}: {len(got['losses'])} steps, launches a fused step "
              f"{ {k_: c for k_, c in want.items() if c} }; loss gap {gap:.3e} (tol "
              f"{BENCH_TOL['f32']}); eval fused {got['eval']:.6f} reference {ref['eval']:.6f}",
              flush=True)
        if gap > BENCH_TOL["f32"]:
            fail(f"{label}: the plans' losses are {gap:.3e} apart")
        return got["eval"], ref["eval"]

    a, b = both("linreg VR-SGD k=64 (Fig. 5)", lambda bk, cb: bench_linreg._run(
        "vr_sgd", 0.09, steps=20, device=dev, backend=bk, callback=cb),
        carry(64, "flat_vr_scale"))
    if rel(a, b) > BENCH_TOL["f32"]:
        fail(f"linreg: test MSE {a} against {b}")
    splits = bench_cifar_proxy.data()
    a, b = both("cifar VR-LAMB b4096 k=32 (Table 6)", lambda bk, cb: bench_cifar_proxy.run_point(
        "vr_lamb", 4096, 8 * 4096, splits, device=dev, backend=bk, callback=cb),
        carry(32, "flat_vr_lamb"))
    if abs(a - b) * len(splits[3]) > BENCH_TOL["acc_samples"]:
        fail(f"cifar: test accuracy {a} against {b}")
    a, b = both("dlrm VR-SGD b4096 k=16 (Table 5)", lambda bk, cb: bench_dlrm_proxy.run_point(
        "vr_sgd", 4096, 8 * 4096, device=dev, backend=bk, callback=cb),
        carry(16, "flat_vr_scale"))
    if abs(a - b) > BENCH_TOL["auc"]:
        fail(f"dlrm: AUC {a} against {b}")

    # the transformer points: each fused step's launches at its k (counted_steps)
    steps = BENCH_POINT_STEPS
    for label, cfg0, run in (
            ("gengap VR-LAMB b256 k=16 (Tables 2, 4)", bench_gengap.config(),
             lambda c, d: bench_gengap.run_point(c, "vr_lamb", steps, *bench_gengap.pool_and_test(),
                                                 device=d)[:2]),
            ("bert proxy VR-LAMB b128 k=8 (Table 1)", bench_bert_proxy.config(),
             lambda c, d: bench_bert_proxy.run_point(c, "vr_lamb", 128, steps,
                                                     bench_bert_proxy.test_batches(c),
                                                     device=d)[:1])):
        log = []
        reset_counts()
        with counted_steps(cfg0.model.n_layers, log):
            got = run(cfg0.replace(parallel=dataclasses.replace(cfg0.parallel, backend=fused)),
                      dev)
        ref = run(cfg0.replace(parallel=dataclasses.replace(cfg0.parallel, backend=plain)), dev)
        for _, counts, _, _ in log:
            for k_, c in counts.items():
                path_counts[k_] = path_counts.get(k_, 0) + c
        gap = max(rel(x, y) for x, y in zip(got, ref))
        print(f"  {label}: {len(log)} fused steps at k {sorted({k for k, *_ in log})}, launches "
              f"a step { {k_: c for k_, c in log[0][1].items() if c} }; eval losses fused "
              f"{', '.join(f'{x:.6f}' for x in got)} reference "
              f"{', '.join(f'{x:.6f}' for x in ref)}: gap {gap:.3e} (tol {BENCH_TOL['bf16']})",
              flush=True)
        if len(log) != steps or gap > BENCH_TOL["bf16"]:
            fail(f"{label}: {len(log)} counted steps, plans {gap:.3e} apart")
    add_path(records, "bench", path_counts)
    print(f"  benches phase wall {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: the other block kinds (MoE, RG-LRU, xLSTM, cross-attention)
# ---------------------------------------------------------------------------

# (a) whisper-small whole (12 + 12 layers, 1,500 frames a row) and (b)
# xlstm-1.3b at full width on two of its six pattern groups (16 layers):
# global batch, seq (k = 8 microbatches, the configs' VR-Adam at lr 1e-3
# with no warm-up), OTHER_STEPS steps a run (xlstm XLSTM_STEPS); (d) one VR step of each MoE
# smoke in its own compute dtype (bf16).  Held by hold_with_witness.
OTHER_STEPS = 3
WHISPER_TRAIN = dict(global_batch=32, seq_len=128)
XLSTM_TRAIN = dict(global_batch=16, seq_len=64, n_layers=16)
XLSTM_STEPS = 2  # OTHER_STEPS before phase 10d came in (PERF.md)
MOE_SMOKES = ("llama4-maverick-400b-a17b", "mixtral-8x22b")
MOE_SMOKE_STEPS = 1
# (c) served at full width: (arch, layers kept or None) through
# Engine.generate at batch, prompt, new tokens
OTHER_SERVE = (("mixtral-8x22b", 8), ("recurrentgemma-9b", None), ("llama-3.2-vision-11b", None))
OTHER_SERVE_SHAPE = (4, 256, 16)
# The witness: the reference plan against itself under the two roundings in
# which the plans differ, attention from f32 q, k, v (F32Attention, as the
# kernels compute it) and, in training, one f32 ulp in every weight after
# the first update (nudge_ulp, the size of the optimizer kernels' rounding).
# A model with attention also trains on the fused plan with ExactDelta: the
# kernels' one rounding that the witness lacks is the backward's
# delta = <dO, O> taken from the bf16 output (the reference's design,
# src/repro/kernels/flash_attention.py:503-507), which moved whisper's
# gsnr/* at step 2 by 4.0e-3 to 5.8e-3, and by 1.2e-4 to 1.6e-4 with delta
# from an f32 forward (H100 80GB HBM3, 700 W; PERF.md).
WITNESS_SEED = 23
# A served MoE model's routing, each plan its own, against the witness's:
# the router inputs at the first MoE layer (which differ only by the first
# attention's arithmetic) at most "first_layer" x the witness's apart, and
# each flip there within the bound of its measured input difference; all
# flips at most "flips" x the witness's (or "floor" of the decisions); the
# mean logit gap at most "free_mean" x the witness's.
ROUTE_GATE = {"first_layer": 2.0, "flips": 2.0, "floor": 0.01, "free_mean": 2.0}


def kind_counts(m):
    """(self-attention layers, cross-attention layers) of a model."""
    kinds = m.pattern_layers()
    self_attn = sum(k in ("attn", "swa", "local", "xattn") for k in kinds)
    return self_attn, sum(k == "xattn" for k in kinds)


def other_fused_counts(m, k, update):
    """Launches of one fused VR step of model ``m`` (scan, remat, k
    microbatches): per microbatch K1 once per encoder layer and twice per
    decoder attention (its forward and the group's recompute), K2 once per
    attention of either; the carry's K3 k times, K4 once, the update once."""
    self_attn, cross = kind_counts(m)
    enc = 0 if m.encoder is None else m.encoder.n_layers
    want = {name: 0 for name in counters()}
    want.update(flash_attention_fwd=k * (enc + 2 * (self_attn + cross)),
                flash_attention_bwd=k * (enc + self_attn + cross),
                flat_moments_accum=k, flat_moments_finalize=1, **{update: 1})
    return want


class F32Attention:
    """Within it, the plain plan's attention (models/attention.py's ``_sdpa``
    and ``_chunked_sdpa``) runs on f32 copies of q, k and v and rounds its
    output to their dtype once, as the kernels do, where the plain plan
    rounds its scores to the compute dtype: the witness's attention."""

    def __enter__(self):
        from repro_torch.models import attention as at

        self.saved = sdpa, chunked = at._sdpa, at._chunked_sdpa
        at._sdpa = lambda q, k, v, mask: sdpa(q.float(), k.float(), v.float(),
                                              mask).to(v.dtype)
        at._chunked_sdpa = lambda q, k, v, *a, **kw: chunked(q.float(), k.float(), v.float(),
                                                             *a, **kw).to(v.dtype)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as at

        at._sdpa, at._chunked_sdpa = self.saved


def nudge_ulp(state, seed):
    """Moves every nonzero weight of a train state one f32 ulp up or down
    (a seeded coin each), in place, in slices of 2^24."""
    import torch

    flat = state.params.data.view(-1)
    gen = torch.Generator(device=flat.device).manual_seed(seed)
    for i in range(0, flat.numel(), 1 << 24):
        x = flat[i:i + (1 << 24)]
        up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        far = torch.where(up, float("inf"), float("-inf")).to(x.dtype)
        x.copy_(torch.where(x != 0, torch.nextafter(x, far), x))


class ExactDelta:
    """Within it, the fused plan's attention backward (FlashAttentionFn)
    takes delta = <dO, O> from the plain forward in f32 (its kernel's plain
    version) instead of the kernel's bf16 output; K1 and K2 run as ever."""

    def __enter__(self):
        import torch

        from repro_torch.kernels import flash_attention as fa

        self.saved = fa.FlashAttentionFn.__dict__["backward"]

        @torch.autograd.function.once_differentiable
        def backward(ctx, do, _dlse):
            q, k, v, out, lse, q_pos, k_pos, q_seg, k_seg = ctx.saved_tensors
            do = do.contiguous()
            exact = fa.attention_fwd_ref(q.float(), k.float(), v.float(), q_pos=q_pos,
                                         k_pos=k_pos, q_seg=q_seg, k_seg=k_seg,
                                         causal=ctx.causal, window=ctx.window)[0]
            delta = (do.float() * exact).sum(dim=-1).transpose(1, 2).contiguous()
            dq, dk, dv = fa.FlashAttentionBwdFn.apply(q, k, v, lse, delta, do, q_pos, k_pos,
                                                      q_seg, k_seg, ctx.causal, ctx.window)
            return dq, dk, dv, None, None, None, None, None, None

        fa.FlashAttentionFn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa

        fa.FlashAttentionFn.backward = self.saved


def step_gaps(a, b):
    """Relative loss and grad-norm gaps and the largest |gsnr/*| gap of two
    runs' metrics at one step."""
    keys = [k for k in ("gsnr/mean", "gsnr/min", "gsnr/frac_floor") if k in b]
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_norm": abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]),
            "gsnr": max((abs(a[key] - b[key]) for key in keys), default=0.0)}


def hold_with_witness(label, hist, bufs):
    """The fused run against the reference run, each step's metrics and the
    first step's buffers (``bufs``: each run's relative gaps to the
    reference run's), beside the witness's gaps to the same reference run.
    Where the witness is past TRAIN_TOL, the reference plan does not
    reproduce its own reading to TRAIN_TOL under rounding, and the gap is
    printed beside the witness's, not gated.  Elsewhere the fused gap is
    held to TRAIN_TOL; past it, the run "exact delta" (where there is one)
    must be within it: the gap is then the kernels' delta rounding, the
    reference kernels' design.  Returns {what: gaps} of the readings not
    gated and of those held through the exact-delta run."""
    ref = hist["reference"]
    runs = [r for r in ("fused", "witness", "exact delta") if r in hist]
    rows = [(f"step {i}", *(step_gaps(hist[r][i], ref[i]) for r in runs))
            for i in range(len(ref))]
    rows.append(("after step 0", *(bufs[r] for r in runs)))
    out = {}
    for what, gf, gw, *gx in rows:
        parts = []
        for key, g in gf.items():
            tol = TRAIN_TOL[{"m": "mv", "v": "mv"}.get(key, key)]
            x = gx[0][key] if gx else None
            note = f"{key} {g:.3e} (witness {gw[key]:.3e}"
            if x is not None:
                note += f", exact delta {x:.3e}"
            if gw[key] > tol:
                note += "; not gated: the witness is past TRAIN_TOL"
                out[f"{what} {key}"] = dict(fused=g, witness=gw[key], exact_delta=x)
            elif g > tol:
                if x is None or x > tol:
                    fail(f"{label} {what}: {key} of the fused and reference runs {g:.3e} apart "
                         f"(TRAIN_TOL {tol}), the witness {gw[key]:.3e}, the exact-delta run "
                         f"{x}")
                note += "; held through the exact-delta run: the gap is delta's rounding"
                out[f"{what} {key}"] = dict(fused=g, witness=gw[key], exact_delta=x)
            parts.append(note + f", tol {tol})")
        print(f"  {label} {what}, fused vs reference: " + "; ".join(parts), flush=True)
    return out


class RouteRecorder:
    """Records every MoE routing decision while ``on`` (models/moe.py's
    ``_route``, wrapped): each call's chosen experts, router logits, router
    input and the router's largest column norm.  Given ``forced`` (an
    earlier run's records, in call order) it routes each call's tokens to
    those experts instead, weighting them by this run's own router
    probabilities renormalised over them, its load-balance reading taken
    over the forced choice as ``_route`` takes it over its own."""

    def __init__(self):
        self.calls, self.on, self.forced = [], False, None

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.saved = moe._route

        def route(p, xf, cfg):
            if self.forced is None:
                w, idx, sel, aux = self.saved(p, xf, cfg)
                if self.on:
                    with torch.no_grad():
                        wr = p["router"].to(xf.dtype)
                        self.calls.append(dict(idx=idx.detach(), logits=(xf @ wr).float(),
                                               x=xf.detach(),
                                               wmax=wr.float().norm(dim=0).max()))
                return w, idx, sel, aux
            if not self.forced or self.forced[0]["idx"].shape[0] != xf.shape[0]:
                fail("a forced run's MoE calls do not follow the recorded run's")
            idx = self.forced.pop(0)["idx"]
            logits = (xf @ p["router"].to(xf.dtype)).float()
            probs = torch.softmax(logits, dim=-1)
            w = probs.gather(-1, idx)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
            sel = moe._one_hot(idx, cfg.n_experts, torch.float32).sum(dim=1)
            lb = cfg.n_experts * torch.sum(sel.mean(dim=0) / cfg.top_k * probs.mean(dim=0))
            z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
            return w, idx, sel, {"moe_lb_loss": cfg.router_aux_weight * lb,
                                 "moe_z_loss": cfg.router_z_weight * z}

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self.saved

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def route_gaps(calls_a, calls_b, top_k, n_moe=None):
    """Run a's routing against run b's, call by call: the token decisions
    and the flips (a token's top-k set differs) over every call; given
    ``n_moe`` (MoE calls per forward, the first of them the first MoE
    layer), also at that layer the router inputs' relative gap, the flips,
    and how many flips have a margin (b's gap between its k-th and
    (k+1)-th logit) past 2 (|dx| max_j |W_j| + 2^-8 max |logit|): the bound
    within which the measured input difference dx, and the bf16 rounding
    of the two router products, can close a margin."""
    import torch

    if len(calls_a) != len(calls_b):
        fail(f"routing records of {len(calls_a)} and {len(calls_b)} MoE calls")
    out = dict(flips=0, decisions=0, first_flips=0, first_unexplained=0, max_margin=0.0,
               max_bound=0.0)
    dx2 = x2 = 0.0
    for i, (a, b) in enumerate(zip(calls_a, calls_b)):
        flip = (a["idx"].sort(dim=-1).values != b["idx"].sort(dim=-1).values).any(dim=-1)
        out["decisions"] += int(flip.numel())
        out["flips"] += int(flip.sum())
        if n_moe is None or i % n_moe:
            continue
        dx = a["x"].float() - b["x"].float()
        dx2 += float(dx.square().sum())
        x2 += float(b["x"].float().square().sum())
        if flip.any():
            top = torch.topk(b["logits"], top_k + 1, dim=-1).values
            margin = (top[:, top_k - 1] - top[:, top_k])[flip]
            bound = 2 * (dx.norm(dim=-1) * b["wmax"]
                         + 2.0**-8 * b["logits"].abs().amax(dim=-1))[flip]
            out["first_flips"] += int(flip.sum())
            out["first_unexplained"] += int((margin > bound).sum())
            out["max_margin"] = max(out["max_margin"], float(margin.max()))
            out["max_bound"] = max(out["max_bound"], float(bound.max()))
    out["first_gap"] = (dx2 / max(x2, 1e-30)) ** 0.5
    return out


def train_other(records, label, cfg, update, path, profile=True, steps=OTHER_STEPS):
    """``steps`` VR steps of ``cfg`` through make_train_step on the
    reference plan, the fused plan (launches asserted per step), the witness
    and, for a model with attention, the fused plan under ExactDelta, each
    from the same params and batches, held by hold_with_witness.  A MoE
    model's routing is recorded and the flips of the fused run and of the
    witness against the reference run counted.  Warm step wall, tokens/s,
    peak memory and a profiled step's idle share of the fused run.  Returns
    a summary."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.launch.serve import stub_shapes
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step

    dev = torch.device("cuda")
    m, o = cfg.model, cfg.optimizer
    moe = m.moe is not None
    torch.cuda.empty_cache()

    def draw():  # the same params for each run, drawn again (one copy held at a time)
        return init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev)

    params = draw()
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    enc = f" + a {m.encoder.n_layers}-layer encoder over {m.encoder.n_frames} frames" \
        if m.encoder is not None else ""
    print(f"[other train] {label}: {m.n_layers} layers ({'/'.join(m.block_pattern)}){enc}, "
          f"d_model {m.d_model}, heads {m.n_heads}/{m.n_kv_heads}, vocab {m.vocab_size}; "
          f"{n_params / 1e9:.3f} B params (analytic {m.param_count() / 1e9:.3f} B); "
          f"{o.name} k={o.k}, global batch {cfg.global_batch}, seq {cfg.seq_len}, "
          f"{cfg.parallel.compute_dtype} compute", flush=True)
    stream = lm_batches(m.vocab_size, cfg.global_batch, cfg.seq_len, seed=0,
                        extra=stub_shapes(m) or None)
    batches = [next(stream) for _ in range(steps + 1)]
    want = other_fused_counts(m, o.k, update)
    hist, bufs, calls, summary, snap0 = {}, {}, {}, {}, {}
    runs = ("reference", "fused", "witness") + (("exact delta",) if sum(kind_counts(m)) else ())
    with RouteRecorder() as rec:
        for run in runs:
            fused = run in ("fused", "exact delta")
            pc = plan_config(cfg, "fused" if fused else "reference")
            in_use = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            state = init_state(pc, params=draw(), device=dev)
            step = make_train_step(pc, log_gsnr=True, device=dev)[0]
            rec.on = moe
            after = (lambda i, st: nudge_ulp(st, WITNESS_SEED) if i == 0 else None) \
                if run == "witness" else None
            ctx = {"witness": F32Attention, "exact delta": ExactDelta}.get(
                run, contextlib.nullcontext)
            t_run = time.perf_counter()
            # the reference run's first-step buffers wait on the host; each
            # other run's are compared with them on the card and let go
            place = dict(snapshots="cpu") if run == "reference" else dict(
                snapshots="cuda", w0_on="cuda" if fused else "cpu",
                on_step0=lambda s1: {nm: rel_diff(s1[nm], snap0[nm]) for nm in snap0})
            with ctx():
                state, hist[run], snap, walls, path_counts = run_plan(
                    run, state, step, batches[:steps], lambda i: want, label, after=after,
                    fused=fused, **place)
            calls[run] = rec.take()
            if run == "reference":
                snap0 = snap
            else:
                bufs[run] = snap
            if run == "fused":
                add_path(records, path, path_counts)
                tokens = cfg.global_batch * cfg.seq_len
                warm = float(np.mean(walls[1:] or walls))
                summary = dict(step_ms=warm, tokens_s=tokens / warm * 1e3,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                print(f"  {label} fused step walls {', '.join(f'{w:.1f}' for w in walls)} ms; "
                      f"warm mean {warm:.1f} ms = {summary['tokens_s']:.0f} tokens/s; peak "
                      f"memory {summary['peak_gib']:.1f} GiB", flush=True)
                if profile:  # the profiled step's state is let go at once
                    t_p = time.perf_counter()
                    t_prof = host_ms(lambda: step(state, batches[steps]))[1]
                    cats = report_profile(f"{label} fused step (profiled)",
                                          lambda: step(state, batches[steps]), t_prof)
                    busy = None if cats is None else sum(c[0] for c in cats.values())
                    summary["idle_share"] = None if busy is None else 1 - busy / t_prof
                    summary["profile_s"] = time.perf_counter() - t_p
            print(f"  {label} {run} run: {in_use:.2f} GiB in use before its state, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                  f"{time.perf_counter() - t_run:.1f} s", flush=True)
            del state, step, snap
            torch.cuda.empty_cache()
    summary["beyond TRAIN_TOL"] = hold_with_witness(label, hist, bufs)
    if moe:
        for run in ("fused", "witness"):
            r = route_gaps(calls[run], calls["reference"], m.moe.top_k)
            summary[f"{run} flips"] = (r["flips"], r["decisions"])
            print(f"  {label} routing, {run} vs reference: {r['flips']} of {r['decisions']} "
                  f"token decisions flipped over {steps} step(s)", flush=True)
    torch.cuda.empty_cache()
    return summary


def phase_other_train(records):
    """16 (a), (b), (d)."""
    import torch

    from repro_torch.configs import get_config, get_smoke

    out, t0 = {}, time.perf_counter()
    whisper = get_config("whisper-small").replace(**WHISPER_TRAIN)
    out["whisper-small"] = train_other(records, "whisper-small", whisper, "flat_vr_adam",
                                       "train whisper-small")
    xl = get_config("xlstm-1.3b")
    xl = xl.replace(global_batch=XLSTM_TRAIN["global_batch"], seq_len=XLSTM_TRAIN["seq_len"],
                    model=dataclasses.replace(xl.model, n_layers=XLSTM_TRAIN["n_layers"]))
    out["whisper-small"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["xlstm-1.3b"] = train_other(records, f"xlstm-1.3b ({xl.model.n_layers} layers)", xl,
                                    "flat_vr_adam", "train xlstm-1.3b", steps=XLSTM_STEPS)
    out["xlstm-1.3b"]["wall_s"] = time.perf_counter() - t0
    for arch in MOE_SMOKES:
        cfg = get_smoke(arch)
        update = {"vr_lamb": "flat_vr_lamb", "vr_adam": "flat_vr_adam"}[cfg.optimizer.name]
        out[f"{arch} smoke"] = train_other(records, f"{arch} smoke", cfg, update,
                                           "train MoE smokes", profile=False,
                                           steps=MOE_SMOKE_STEPS)
    torch.cuda.empty_cache()
    return out


def hold_other(label, eng, reng, prompts, extra, res, m):
    """The fused and plain plans teacher-forced along the fused tokens, as
    hold_plans does, with the model's cross-attention source and its own
    launch counts (K1 per self- and cross-attention layer at prefill, K12
    per self-attention layer per decode step; the cross decode is plain),
    within SERVE_GATE.  A MoE model's routing is recorded on both plans and
    on the witness (the plain plan under F32Attention) and held to
    ROUTE_GATE against it (route_gaps); SERVE_GATE then holds on a fourth
    run, the plain plan routed to the fused run's experts, so that the plans
    differ there only by what they compute.  Returns (max, mean) |diff| of
    the gated pair and the routing record."""
    import torch

    dev = eng.device
    b, s = prompts.shape
    new = res.tokens.shape[1]
    toks = torch.as_tensor(prompts, device=dev)
    fused_toks = torch.as_tensor(res.tokens, device=dev).long()
    ex = None if extra is None else {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}
    self_attn, cross = kind_counts(m)

    def teacher_forced(e):
        logits, cache = e._prefill(toks, extra=ex)
        out = [logits[:, -1]]
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        for t in range(new - 1):
            logits, cache = e._decode(cache, fused_toks[:, t:t + 1], pos)
            out.append(logits[:, -1])
            pos = pos + 1
        return torch.stack(out, 1)

    def gaps(a, c):
        diff = (a - c).abs()
        return float(diff.max()), float(diff.mean())

    routing = None
    with torch.no_grad(), RouteRecorder() as rec:
        rec.on = m.moe is not None
        reset_counts()
        tf_f = teacher_forced(eng)
        got = read_counts()
        want = {"flash_attention_fwd": self_attn + cross, "flash_decode": self_attn * (new - 1)}
        if {k: got[k] for k in SERVE_KERNELS} != want:
            fail(f"{label}: teacher-forced fused launches {got}, want {want}")
        calls_f = rec.take()
        tf_r = teacher_forced(reng)
        calls_r = rec.take()
        if m.moe is not None:
            with F32Attention():
                tf_w = teacher_forced(reng)
            calls_w = rec.take()
            if len(calls_f) % new:
                fail(f"{label}: {len(calls_f)} MoE calls over {new} forwards")
            n_moe = len(calls_f) // new
            rf, rw = (route_gaps(c, calls_r, m.moe.top_k, n_moe) for c in (calls_f, calls_w))
            free_f, free_w = gaps(tf_f, tf_r), gaps(tf_w, tf_r)
            for who, r, free in (("fused", rf, free_f), ("witness", rw, free_w)):
                print(f"  {label} MoE routing, {who} vs reference (each its own): {r['flips']} "
                      f"of {r['decisions']} token decisions flipped; at the first MoE layer "
                      f"router inputs {r['first_gap']:.3e} apart (relative), "
                      f"{r['first_flips']} flips, margins max {r['max_margin']:.3e}, bounds "
                      f"max {r['max_bound']:.3e}, {r['first_unexplained']} past their bound; "
                      f"logits max |diff| {free[0]:.4f}, mean {free[1]:.5f}", flush=True)
            limit = max(ROUTE_GATE["flips"] * rw["flips"], ROUTE_GATE["floor"] * rf["decisions"])
            print(f"  {label} ROUTE_GATE: first-layer gap {rf['first_gap']:.3e} <= "
                  f"{ROUTE_GATE['first_layer']} x {rw['first_gap']:.3e}; flips {rf['flips']} <= "
                  f"{limit:.0f}; mean logit gap {free_f[1]:.5f} <= {ROUTE_GATE['free_mean']} x "
                  f"{free_w[1]:.5f}", flush=True)
            if rf["first_unexplained"] or rw["first_unexplained"]:
                fail(f"{label}: a routing flip at the first MoE layer past what its measured "
                     "input difference can close")
            if not rf["first_gap"] <= ROUTE_GATE["first_layer"] * rw["first_gap"]:
                fail(f"{label}: the plans' router inputs at the first MoE layer are further "
                     "apart than the witness's")
            if rf["flips"] > limit:
                fail(f"{label}: the plans' routing flips past ROUTE_GATE")
            if not free_f[1] <= ROUTE_GATE["free_mean"] * free_w[1]:
                fail(f"{label}: the plans' logits further apart than ROUTE_GATE allows")
            rec.on, rec.forced = False, list(calls_f)
            tf_routed = teacher_forced(reng)
            if rec.forced:
                fail(f"{label}: {len(rec.forced)} recorded routings left unused")
            routing = dict(flips=rf["flips"], decisions=rf["decisions"],
                           witness_flips=rw["flips"], first_gap=rf["first_gap"],
                           witness_first_gap=rw["first_gap"], first_flips=rf["first_flips"],
                           free_max=free_f[0], free_mean=free_f[1], witness_free_max=free_w[0],
                           witness_free_mean=free_w[1])
            tf_r = tf_routed
    d_max, d_mean = gaps(tf_f, tf_r)
    what = "the plain plan routed as the fused plan" if m.moe is not None else "reference"
    print(f"  {label} teacher-forced, all {new} steps: max |fused - {what}| = {d_max:.4f}, "
          f"mean {d_mean:.5f}, logit std {float(tf_r.std()):.3f} (tol max {SERVE_GATE['max']}, "
          f"mean {SERVE_GATE['mean']})", flush=True)
    if not (d_max <= SERVE_GATE["max"] and d_mean <= SERVE_GATE["mean"]):
        fail(f"{label}: the fused and reference plans disagree beyond SERVE_GATE")
    return d_max, d_mean, routing


def serve_other(records, arch, n_layers):
    import torch

    from repro_torch.backend import Backend
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_inputs, weight_dtype
    from repro_torch.models import init_params
    from repro_torch.serve import Engine

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_layers=n_layers))
    m = cfg.model
    dtype = weight_dtype(cfg, dev)
    b, s, new = OTHER_SERVE_SHAPE
    cache_len = s + new + 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(m, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    eng = Engine(cfg, params, cache_len=cache_len, device=dev)
    self_attn, cross = kind_counts(m)
    cut = f" (of {get_config(arch).model.n_layers})" if n_layers else ""
    print(f"[other serve] {m.name}: {m.n_layers} layers{cut} ({'/'.join(m.block_pattern)}), "
          f"d_model {m.d_model}, heads {m.n_heads}/{m.n_kv_heads} (head dim "
          f"{m.resolved_head_dim}), d_ff {m.d_ff}, vocab {m.vocab_size}; {n_params / 1e9:.3f} B "
          f"params (analytic {m.param_count() / 1e9:.3f} B) held in {dtype}: "
          f"{w_bytes / 1e9:.2f} GB, drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, m.vocab_size, size=(b, s))
    extra = stub_inputs(cfg, b, rng)
    eng.generate(prompts, 2, extra=extra)  # warm-up
    _, t_prefill = host_ms(lambda: eng.generate(prompts, 0, extra=extra))
    reset_counts()
    res, t_total = host_ms(lambda: eng.generate(prompts, new, extra=extra))
    counts = read_counts()
    want = {name: 0 for name in counts}
    want.update(flash_attention_fwd=self_attn + cross, flash_decode=self_attn * new)
    if counts != want:
        fail(f"{arch}: launch counts {counts} != expected {want}")
    for name in SERVE_KERNELS:
        records[name].setdefault("launches_by_path", {})[f"serve {arch}"] = counts[name]
    if res.tokens.shape != (b, new) or not np.isfinite(res.logprobs).all() \
            or not ((res.tokens >= 0) & (res.tokens < m.vocab_size)).all():
        fail(f"{arch}: generate returned {res.tokens.shape} tokens, non-finite logprobs or tokens "
             "out of vocabulary")
    decode_ms = t_total - t_prefill
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  launches in generate: K1 {counts['flash_attention_fwd']} ({self_attn} self + "
          f"{cross} cross), K12 {counts['flash_decode']}, none else; prefill (B={b}, S={s}) "
          f"{t_prefill:.1f} ms (host clock); decode {new} steps {decode_ms:.1f} ms = "
          f"{b * new / decode_ms * 1e3:.1f} tok/s; peak memory {peak / 1e9:.2f} GB", flush=True)
    toks = torch.as_tensor(prompts, device=dev)
    ex = None if extra is None else {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}
    with torch.no_grad():
        _, t_pre = host_ms(lambda: eng._prefill(toks, extra=ex))
        cats = report_profile(f"{arch} prefill (profiled)", lambda: eng._prefill(toks, extra=ex),
                              t_pre)
    busy = None if cats is None else sum(c[0] for c in cats.values())
    # the plain plan over the same weights and compute copy
    reng = copy.copy(eng)
    reng.cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                        backend=Backend.all_reference()))
    gate = hold_other(arch, eng, reng, prompts, extra, res, m)
    del eng, reng, params, leaves
    torch.cuda.empty_cache()
    return dict(prefill_ms=t_prefill, decode_tok_s=b * new / decode_ms * 1e3,
                peak_gb=peak / 1e9, weights_gb=w_bytes / 1e9, dtype=str(dtype),
                prefill_idle=None if busy is None else 1 - busy / t_pre,
                gate_max=gate[0], gate_mean=gate[1], routing=gate[2])


def cross_attention_shapes(records):
    """16 (e): K1 (with its LSE) and K2 at the encoder and cross-attention
    shapes of (a), K1 at the vision model's cross-attention prefill shape of
    (c), and K1 / K12 at recurrentgemma's head dim 256 (c): each against its
    plain version on the same inputs, timed in turns with it and SDPA, beside
    its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flash_decode as fd

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev,
                                                                                   torch.bfloat16)

    def rows(n, b):
        return torch.arange(n, dtype=torch.int32, device=dev)[None].repeat(b, 1)

    mb = WHISPER_TRAIN["global_batch"] // 8
    b_s, s_s, new = OTHER_SERVE_SHAPE
    # tag: (B, Sq, Skv, H, KV, D, causal, window, with the backward)
    shapes = {
        "whisper encoder": (mb, 1500, 1500, 12, 12, 64, False, 0, True),
        "whisper cross": (mb, WHISPER_TRAIN["seq_len"], 1500, 12, 12, 64, False, 0, True),
        "vision cross": (b_s, s_s, 1601, 32, 8, 128, False, 0, False),
        "recurrentgemma local D256": (b_s, s_s, s_s, 16, 1, 256, True, 2048, False),
    }
    for tag, (b, sq, skv, h, kvh, d, causal, window, bwd) in shapes.items():
        q, k, v = randn(b, sq, h, d), randn(b, skv, kvh, d), randn(b, skv, kvh, d)
        qp, kp = rows(sq, b), rows(skv, b)
        qs, ks = torch.zeros_like(qp), torch.zeros_like(kp)
        ops = (qp, kp, qs, ks)
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention(q, k, v, *ops, with_lse=True, **kw)
        want, wlse = fa.attention_fwd_ref(q, k, v, q_pos=qp, k_pos=kp, q_seg=qs, k_seg=ks, **kw)
        err1 = max(check_close(f"{tag} K1 B{b} Sq{sq} Skv{skv} H{h}/{kvh} D{d} out", out, want,
                               tol_scaled(want)),
                   check_close(f"{tag} K1 lse", lse, wlse, TOL_F32))
        mask = fa.attention_mask(qp, kp, qs, ks, **kw)
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
        am = mask[:, None]
        t1 = cuda_ms_interleaved({
            "kernel": lambda: fa.flash_attention(q, k, v, *ops, with_lse=True, **kw),
            "plain": lambda: fa.attention_fwd_ref(q, k, v, q_pos=qp, k_pos=kp, q_seg=qs,
                                                  k_seg=ks, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)})
        pairs = int(mask.sum()) * h
        b1 = bound(nbytes(q, k, v, *ops, out, lse), pairs * 4 * d, "bfloat16")
        print(f"  {tag} K1 (ms): kernel={t1['kernel']:.4f} plain={t1['plain']:.4f} "
              f"sdpa={t1['sdpa']:.4f} bound={b1[0]:.4f} ({b1[1]})", flush=True)
        entries = [("flash_attention_fwd", err1, t1, b1)]
        if bwd:
            do = randn(b, sq, h, d)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, lse, delta, do, *ops)
            got = fab.flash_attention_bwd(*args, **kw)
            wgot = fab.attention_bwd_ref(q, k, v, lse, delta, do, q_pos=qp, k_pos=kp, q_seg=qs,
                                         k_seg=ks, **kw)
            err2 = max(check_close(f"{tag} K2 {g}", a, w, tol_scaled(w))
                       for g, a, w in zip(("dq", "dk", "dv"), got, wgot))
            t2 = cuda_ms_interleaved({
                "kernel": lambda: fab.flash_attention_bwd(*args, **kw),
                "plain": lambda: fab.attention_bwd_ref(q, k, v, lse, delta, do, q_pos=qp,
                                                       k_pos=kp, q_seg=qs, k_seg=ks, **kw)})
            t2["sdpa"] = sdpa_bwd_ms(q, k, v, do, mask)
            b2 = bound(nbytes(q, k, v, lse, delta, do, *ops, *got), pairs * 10 * d, "bfloat16")
            print(f"  {tag} K2 (ms): kernel={t2['kernel']:.4f} plain={t2['plain']:.4f} "
                  f"sdpa={t2['sdpa']:.4f} bound={b2[0]:.4f} ({b2[1]})", flush=True)
            entries.append(("flash_attention_bwd", err2, t2, b2))
            del do, delta, args, got, wgot
        for name, err, t, bd in entries:
            r = records[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r[tag] = dict(shape=f"B{b} Sq{sq} Skv{skv} H{h}/{kvh} D{d} bf16 "
                                f"{'causal' if causal else 'non-causal'}"
                                f"{f' window {window}' if window else ''}",
                          max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                          library_ms=t["sdpa"], bound_ms=bd[0], bound_by=bd[1])
        del q, k, v, qt, kt, vt, am, mask, out, lse, want, wlse
    # K12 at recurrentgemma's decode shape: one lane a row, 16 query heads on
    # one kv head of dim 256, the local window's ring of cache_len slots
    cache_len = s_s + new + 8
    b, h, kvh, d = b_s, 16, 1, 256
    qd = randn(b, 1, h, d)
    kc, vc = randn(b, cache_len, kvh, d), randn(b, cache_len, kvh, d)
    qp, kp, qs, ks = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in paged_cache(b, cache_len, 1, s_s + new, rng))
    got = fd.flash_decode(qd, kc, vc, qp, kp, qs, ks, window=2048)
    err12 = check_close(f"recurrentgemma K12 B{b} C{cache_len} L1 H{h}/{kvh} D{d} window 2048",
                        got, fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks, window=2048),
                        TOL_BF16_OUT)
    dmask = fa.attention_mask(qp, kp, qs, ks, causal=True, window=2048)
    qt = qd.transpose(1, 2).contiguous()
    kt = kc.transpose(1, 2).repeat_interleave(h, dim=1).contiguous()
    vt = vc.transpose(1, 2).repeat_interleave(h, dim=1).contiguous()
    am = dmask[:, None]
    t12 = cuda_ms_interleaved({
        "kernel": lambda: fd.flash_decode(qd, kc, vc, qp, kp, qs, ks, window=2048),
        "plain": lambda: fd.decode_attention_ref(qd, kc, vc, qp, kp, qs, ks, window=2048),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)})
    kv_need = int(dmask.any(dim=1).sum()) * kvh * d * kc.element_size() * 2
    b12 = bound(nbytes(qd, qp, kp, qs, ks, got) + kv_need, int(dmask.sum()) * h * 4 * d,
                "bfloat16")
    print(f"  recurrentgemma K12 (ms): kernel={t12['kernel']:.6f} plain={t12['plain']:.6f} "
          f"sdpa={t12['sdpa']:.6f} bound={b12[0]:.6f} ({b12[1]})", flush=True)
    r = records["flash_decode"]
    r["max_abs_err"] = max(r["max_abs_err"], err12)
    r["recurrentgemma D256"] = dict(shape=f"B{b} C{cache_len} L1 H{h}/{kvh} D{d} bf16",
                                    max_abs_err=err12, ms=t12["kernel"], plain_ms=t12["plain"],
                                    library_ms=t12["sdpa"], bound_ms=b12[0], bound_by=b12[1])


def phase_other_blocks(records):
    """16: the other block kinds at full width: (a) whisper-small and (b)
    xlstm-1.3b trained, (c) mixtral-8x22b, recurrentgemma-9b and
    llama-3.2-vision-11b served, (d) one VR step of each MoE smoke, (e) K1,
    K2 and K12 at the new shapes.  Prints one summary line."""
    import torch

    t0 = time.perf_counter()
    summary = {"train": phase_other_train(records), "serve": {}, "walls_s": {}}
    summary["walls_s"]["train"] = time.perf_counter() - t0
    for arch, n_layers in OTHER_SERVE:
        t1 = time.perf_counter()
        summary["serve"][arch] = serve_other(records, arch, n_layers)
        summary["walls_s"][f"serve {arch}"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cross_attention_shapes(records)
    summary["walls_s"]["kernel shapes"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    summary["wall_s"] = time.perf_counter() - t0
    print(f"[other blocks] {json.dumps(summary)}", flush=True)


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

    t0 = t_start = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(_build.sources())} sources in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)

    from repro_torch.configs import get_config

    records, walls = {}, {}

    def timed(tag, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[tag] = time.perf_counter() - t
        print(f"[wall] phase {tag}: {walls[tag]:.1f} s", flush=True)
        return out

    bert = get_config("bert-large")
    layout = train_layout(bert)
    data = make_token_caches(bert.model.vocab_size)  # phase 13(a)'s; phase 7 packs rows too
    try:
        timed("3", phase_kernels, records)
        timed("4-6", phase_engine, records)
        torch.cuda.empty_cache()
        timed("6b", phase_dense_serving, records)
        timed("7", phase_train_kernels, records, layout, data)
        scan = timed("8", phase_train, records)
        timed("11", phase_train_vmap, records, scan)  # against phase 8's scan steps
        del scan
        torch.cuda.empty_cache()
        timed("13", phase_autoscale, records, data)  # before phases 9 and 10b, after which
        torch.cuda.empty_cache()                      # the profiler has seen no device events
        timed("9", phase_train_optimizers, records)
        timed("10a", phase_spmd_kernels, records, layout)
        timed("7b", phase_norm_sums, records)
        timed("10b", phase_train_dp, records, DP_GROUPS, "10b")
        timed("10c", phase_train_dp, records, DP_PATH_GROUPS, "10c")
        timed("10d", phase_train_grid, records)
        timed("12", phase_per_leaf, records, layout)
        torch.cuda.empty_cache()
        timed("14", phase_dlrm, records)
        torch.cuda.empty_cache()
        timed("15", phase_benches, records)
        torch.cuda.empty_cache()
        timed("16", phase_other_blocks, records)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(data["dir"], ignore_errors=True)
    print(f"[walls] {json.dumps({k: round(v, 1) for k, v in walls.items()})}; the script "
          f"{time.perf_counter() - t_start:.1f} s with the build", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    records.pop("_dense_serve", None)
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
