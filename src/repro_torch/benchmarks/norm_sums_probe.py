"""The LAMB/LARS norm sums of a parent commit's kernels against f64 sums,
and the kernels' times beside this tree's.

Two parents, each with its own table of C signatures below:

* 2e7ac75: the per-leaf Σu² and Σw² that the trust ratios of K5
  (``flat_vr_lamb``), K7 (``flat_vr_lars``), K16 (``spmd_vr_lamb_compute``)
  and K17 (``spmd_vr_lars_compute``) read were one f32 ``atomicAdd`` per
  64-row block; this tree adds the blocks' f64 partials in block order
  (``csrc/flat_update.cuh``), which ``chip_smoke.py``'s phase 7b holds on
  every run.  The probe shows the old drift on phase 7b's inputs (a leaf of
  131,072 blocks; K16/K17 on a padded row shard of it) and times K5 and K7
  of both commits in turns at bert-large's flat layout.  ~35 GB.
* d548add: each block of ``csrc/vr_leaf.cu``'s grid-stride grid (at most
  16 an SM) added K20 (``vr_lamb_inner``) and K21 (``vr_lars_inner``)'s Σu²
  and Σw² to two f32 accumulators with one ``atomicAdd``; this tree writes
  each block's sums to f64 slots and the last block adds them in block
  order (``leaf_norm_sums``), which phase 12 holds on every run.  The probe
  runs both on phase 12's leaf, bert-large's (24, 1024, 4096), prints each
  sum's distance from an f64 sum and whether a repeat gives the same bits,
  and times both kernels in turns, each with this tree's prepass.  ~6 GB.

  git archive PARENT src/repro_torch/kernels/csrc | tar -x -C build/parent
  PYTHONPATH=src python -m repro_torch.benchmarks.norm_sums_probe PARENT \\
      build/parent/src/repro_torch/kernels/csrc

Needs one Hopper card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.layout import ParamLayout, pad_mask, stack_groups
from repro_torch.kernels import _build
from repro_torch.kernels import flat_spmd as fsp
from repro_torch.kernels import flat_update as fu
from repro_torch.kernels import vr_lamb as vl
from repro_torch.kernels import vr_update as vu
from repro_torch.models import init_params

BIG_ROWS = 1 << 23  # the big leaf: 2^30 elements, 131,072 blocks
PAD_BLOCKS = 2
LEAF = (24, 1024, 4096)  # bert-large's stacked MLP input weight, phase 12's leaf
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# {parent: {library: {function: argtypes}}}, each the parent's C interface
PARENT_SIGNATURES = {
    "2e7ac75": {
        "flat_update": {"flat_vr_lamb": [_P] * 12 + [_I, _I, _I] + [_F] * 11 + [_P],
                        "flat_vr_lars": [_P] * 10 + [_I, _I] + [_F] * 6 + [_P]},
        "flat_spmd": {"spmd_vr_lamb_compute": [_P] * 12 + [_I, _I, _I] + [_F] * 10 + [_P],
                      "spmd_vr_lars_compute": [_P] * 9 + [_I, _I, _F, _F, _F, _P]},
    },
    "d548add": {
        "vr_leaf": {"leaf_vr_adam": [_P] * 13 + [_L] + [_F] * 10 + [_I] * 2 + [_P],
                    "leaf_vr_lars": [_P] * 7 + [_L, _F, _F, _F, _I, _P]},
    },
}
LAMB = dict(b1=0.9, b2=0.999, b3=0.9, eps=1e-6, wd=0.01, gamma=0.1, gsnr_eps=1e-12)
LARS = dict(wd=1e-4, gamma=0.1, eps=1e-12)
SCAL = (1e-3, 0.19, 0.001999, 0.19)  # lr, bc1, bc2, bc3


def parent_libs(parent: str, csrc: str):
    """The parent's libraries of its signature table, built in parallel from
    ``csrc`` into build/parent_kernels."""
    out = _build.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    table = PARENT_SIGNATURES[parent]
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(Path(csrc) / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in table}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{parent}'s {name}.cu did not build:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in table[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, fn, *args):
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's {fn}: CUDA error {err}")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def probe_gaps(libs, dev) -> None:
    """2e7ac75's K5/K7/K16/K17 on a leaf of 131,072 blocks: the relative gap
    of the big leaf's Σu² and Σw² to an f64 sum of the same u and w.  K5's
    u is rebuilt in f64 from its m', v' and w; K7 and K17 run at gamma 1
    (r = 1, u = ga + wd w); K16 and K17 return their u."""
    layout = ParamLayout(("a", "big", "c"), ((3, 70), (BIG_ROWS, 128), (5,)))
    n, slots, nb = layout.n_rows, layout.leaf_slots, layout.n_blocks
    big = layout.paths.index("big")
    first, extra = layout.row_offsets[big], PAD_BLOCKS * 64
    gen = torch.Generator(device=dev).manual_seed(21)
    mask = pad_mask(layout, dev)

    def buf(fill):
        x = torch.empty((n + extra, 128), device=dev)
        fill(x)
        x[:n].mul_(mask)
        x[n:].zero_()
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

    meta = layout.device_meta(dev)
    ids, inv = meta["block_leaf_ids"], meta["inv_sizes"]
    lids = torch.cat((ids[first // 64:], torch.zeros(PAD_BLOCKS, dtype=torch.int32, device=dev)))
    shard_rows = lids.numel() * 64
    full, shard = slice(0, n), slice(first, first + shard_rows)
    racc = fsp.leaf_r_partials(g[shard], g2[shard], lids, slots, gsnr_eps=1e-12)
    c = {k: float(np.float32(x)) for k, x in (("bc1", SCAL[1]), ("bc2", SCAL[2]),
                                              ("eps", LAMB["eps"]), ("wd", LAMB["wd"]))}
    fu_lib, sp_lib = libs["flat_update"], libs["flat_spmd"]

    def k5():
        acc = torch.empty((3, slots), device=dev)
        part = torch.empty(nb + 1, dtype=torch.float64, device=dev)
        _call(fu_lib, "flat_vr_lamb", *_ptrs(g, g, g2, m, v, p, w, torch.empty_like(g[full]), ids,
                                             inv, acc, part), slots, nb, 0, *SCAL,
              *LAMB.values())
        u = lambda sl: ((m[sl].double() / c["bc1"])  # noqa: E731
                        / ((v[sl].double() / c["bc2"]).sqrt() + c["eps"])
                        + c["wd"] * w[sl].double())
        return acc[1:], u, meta["row_ids"], n, 0

    def k7():
        acc = torch.empty((3, slots), device=dev)
        part = torch.empty(nb + 1, dtype=torch.float64, device=dev)
        _call(fu_lib, "flat_vr_lars", *_ptrs(g, g, g2, m, w, torch.empty_like(g[full]), ids, inv,
                                             acc, part), slots, nb, 1e-3, 1.0, 0.9, 0.01, 0.001,
              1e-12)
        return acc[1:], lambda sl: g[sl].double() + c["wd"] * w[sl].double(), \
            meta["row_ids"], n, 0

    shard_ids = torch.cat((meta["row_ids"][first:],
                           torch.zeros(extra, dtype=torch.long, device=dev)))

    def k16():
        acc, u = torch.empty((2, slots), device=dev), torch.empty_like(g[shard])
        _call(sp_lib, "spmd_vr_lamb_compute",
              *_ptrs(g[shard], g[shard], g2[shard], m[shard], v[shard], p[shard], w[shard], u,
                     lids, inv, racc, acc), slots, lids.numel(), 0, *SCAL[1:],
              *LAMB.values())
        return acc, lambda sl: u[sl].double(), shard_ids, shard_rows, first

    def k17():
        acc, u = torch.empty((2, slots), device=dev), torch.empty_like(g[shard])
        _call(sp_lib, "spmd_vr_lars_compute",
              *_ptrs(g[shard], g[shard], g2[shard], w[shard], u, lids, inv, racc, acc), slots,
              lids.numel(), 1.0, 0.01, 1e-12)
        return acc, lambda sl: u[sl].double(), shard_ids, shard_rows, first

    print(f"leaves {layout.paths}: big leaf {BIG_ROWS * 128} elements ({BIG_ROWS // 64} blocks); "
          f"K16/K17 on rows {first}.. plus {PAD_BLOCKS} pad blocks", flush=True)
    for label, run in (("K5 flat_vr_lamb", k5), ("K7 flat_vr_lars (gamma 1)", k7),
                       ("K16 spmd_vr_lamb_compute (padded shard)", k16),
                       ("K17 spmd_vr_lars_compute (padded shard, gamma 1)", k17)):
        reset()
        got, u, row_ids, rows, off = run()
        want = torch.zeros((2, slots), dtype=torch.float64, device=dev)
        for i in range(0, rows, 1 << 20):
            sl = slice(i, min(i + (1 << 20), rows))
            wsl = slice(sl.start + off, sl.stop + off)
            want[0].index_add_(0, row_ids[sl], u(sl).square().sum(dim=1))
            want[1].index_add_(0, row_ids[sl], w[wsl].double().square().sum(dim=1))
        gap = (got[:, big].double() - want[:, big]).abs() / want[:, big]
        print(f"  2e7ac75 {label}: big leaf Σu² {float(got[0, big]):.9e} (f64 "
              f"{float(want[0, big]):.9e}), Σw² {float(got[1, big]):.9e} (f64 "
              f"{float(want[1, big]):.9e}): relative gaps {float(gap[0]):.3e}, "
              f"{float(gap[1]):.3e}", flush=True)
    del g, g2, w, m, v, p, racc, mask
    torch.cuda.empty_cache()


def leaf_inputs(dev):
    """Phase 12's operands of the leaf, from the same seed."""
    gen = torch.Generator(device=dev).manual_seed(12)

    def rand(scale, positive=False):
        x = torch.randn(LEAF, generator=gen, device=dev).mul_(scale)
        return x.abs_() if positive else x

    g = rand(1e-2)
    return dict(g=g, ga=g * 0.7, g2=(g * g).add_(rand(1e-4, True)), m=rand(1e-3),
                v=rand(1e-5, True), p=rand(1.0, True).clamp_(max=1.0), w=rand(0.05))


def leaf_parent_calls(lib, x):
    """(lamb(), lars()) calling d548add's kernels: each returns (u, acc), on
    the stream current at the call (a graph capture's)."""
    ops = {k: vu.pad2d(t) for k, t in x.items()}

    def lamb():
        n_sm, stream = vu.stream_args(x["g"])
        inv = vu.leaf_inv_mean(x["g"], x["g2"], LAMB["gsnr_eps"])
        outs = [torch.empty_like(ops["g"]) for _ in range(4)]
        acc = torch.empty(2, dtype=torch.float32, device=x["g"].device)
        h = LAMB
        err = lib.leaf_vr_adam(*(ops[k].data_ptr() for k in ("g", "ga", "g2", "m", "v", "p", "w")),
                               inv.data_ptr(), *(t.data_ptr() for t in outs), acc.data_ptr(),
                               outs[0].numel(), h["b1"], h["b2"], h["b3"], h["eps"], h["wd"],
                               h["gamma"], h["gsnr_eps"], *SCAL[1:], 1, n_sm, stream)
        if err:
            raise RuntimeError(f"d548add's leaf_vr_adam: CUDA error {err}")
        return outs[0], acc

    def lars():
        n_sm, stream = vu.stream_args(x["g"])
        inv = vu.leaf_inv_mean(x["g"], x["g2"], LARS["eps"])
        u = torch.empty_like(ops["g"])
        acc = torch.empty(2, dtype=torch.float32, device=x["g"].device)
        err = lib.leaf_vr_lars(*(ops[k].data_ptr() for k in ("g", "ga", "g2", "w")),
                               inv.data_ptr(), u.data_ptr(), acc.data_ptr(), u.numel(),
                               LARS["gamma"], LARS["wd"], LARS["eps"], n_sm, stream)
        if err:
            raise RuntimeError(f"d548add's leaf_vr_lars: CUDA error {err}")
        return u, acc

    return lamb, lars


def leaf_this_calls(x):
    def lamb():
        out = vl.vr_lamb_inner(x["g"], x["ga"], x["g2"], x["m"], x["v"], x["p"], x["w"], *SCAL[1:],
                               **LAMB)
        return out[0], torch.stack(out[-2:])

    def lars():
        out = vl.vr_lars_inner(x["g"], x["ga"], x["g2"], x["w"], **LARS)
        return out[0], torch.stack(out[-2:])

    return lamb, lars


def leaf_gaps(call, w):
    """Each sum's relative distance from an f64 sum of the same u and w, and
    whether a repeat gives the same bits."""
    u, acc = call()
    _, again = call()
    want = (u.double().square().sum(), w.double().square().sum())
    return [abs(float(a) - float(b)) / float(b) for a, b in zip(acc, want)], \
        torch.equal(acc, again)


def _graph(fn):
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def _replay_ms(graph) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_in_turns(libs, dev, iters: int = 25) -> None:
    """K5 and K7 of 2e7ac75 and of this tree at bert-large's flat layout,
    each captured in a CUDA graph and replayed in turns; medians in ms."""
    meta_params = init_params(get_config("bert-large").model, torch.Generator().manual_seed(0),
                              device="meta")
    layout = ParamLayout.for_tree(stack_groups(meta_params))
    gen = torch.Generator(device=dev).manual_seed(3)
    mask = pad_mask(layout, dev)

    def rand(scale, positive=False):
        x = torch.empty((layout.n_rows, 128), device=dev).normal_(0.0, scale, generator=gen)
        return (x.abs_() if positive else x).mul_(mask)

    g = rand(1e-3)
    g2 = (g * g).add_(rand(1e-6, positive=True))
    ga, w = g * 0.5, rand(0.03)
    m, v, p = rand(1e-4), rand(1e-7, positive=True), mask.float().mul_(0.4)
    meta = layout.device_meta(dev)
    ids, inv, slots, nb = meta["block_leaf_ids"], meta["inv_sizes"], layout.leaf_slots, \
        layout.n_blocks
    upd, acc = torch.empty_like(g), torch.empty((3, slots), device=dev)
    part = torch.empty(nb + 1, dtype=torch.float64, device=dev)
    fu_lib = libs["flat_update"]
    scal = (3.5e-6, *SCAL[1:])
    fns = {
        "K5 2e7ac75": lambda: _call(fu_lib, "flat_vr_lamb", *_ptrs(
            g, ga, g2, m, v, p, w, upd, ids, inv, acc, part), slots, nb, 0, *scal,
            *LAMB.values()),
        "K5 this tree": lambda: fu.flat_vr_lamb(g, ga, g2, m, v, p, w, scal, layout, **LAMB),
        "K7 2e7ac75": lambda: _call(fu_lib, "flat_vr_lars", *_ptrs(
            g, ga, g2, m, w, upd, ids, inv, acc, part), slots, nb, 3.5e-3, 0.1, 0.9, 0.01, 0.001,
            1e-12),
        "K7 this tree": lambda: fu.flat_vr_lars(g, ga, g2, m, w, (3.5e-3, 0.1), layout, mu=0.9,
                                                wd=0.01, trust=0.001, eps=1e-12),
    }
    graphs = {name: _graph(fn) for name, fn in fns.items()}
    times = {name: [] for name in fns}
    for _ in range(iters):
        for name, graph in graphs.items():
            times[name].append(_replay_ms(graph))
    print(f"K5 and K7 at bert-large's flat layout ({layout.n_rows} rows), in turns (median ms "
          f"of {iters}): " + "; ".join(f"{k} {np.median(t):.6f}" for k, t in times.items()),
          flush=True)


def probe_leaf(lib, dev) -> None:
    """d548add's K20/K21 against this tree's on phase 12's leaf: each sum's
    distance from an f64 sum, repeat bits, and their times in turns."""
    _build.build_all()
    x = leaf_inputs(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-x["g"].numel() // (4 * 128)), vu.STEP_BLOCKS_PER_SM * n_sm)
    print(f"leaf {LEAF}: {x['g'].numel()} f32 elements, {blocks} blocks", flush=True)
    parent, this = leaf_parent_calls(lib, x), leaf_this_calls(x)
    for name, i in (("K20 vr_lamb_inner", 0), ("K21 vr_lars_inner", 1)):
        for tree, calls in (("d548add (f32 atomics)", parent), ("this tree (f64 combine)", this)):
            (gu, gw), same = leaf_gaps(calls[i], x["w"])
            print(f"  {name} {tree}: sum(u^2) {gu:.3e}, sum(w^2) {gw:.3e} off an f64 sum; "
                  f"repeat bit-identical: {same}", flush=True)
    for name, i in (("K20 vr_lamb_inner", 0), ("K21 vr_lars_inner", 1)):
        graphs = {"d548add": _graph(parent[i]), "this": _graph(this[i]),
                  "d548add again": _graph(parent[i]), "this again": _graph(this[i])}
        times = {k: [] for k in graphs}
        for _ in range(25):
            for k, g in graphs.items():
                times[k].append(_replay_ms(g))
        print(f"  {name} with its prepass (ms, medians of 25 replays in turns): " +
              ", ".join(f"{k} {float(np.median(t)):.4f}" for k, t in times.items()), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in PARENT_SIGNATURES:
        raise SystemExit(__doc__)
    dev = torch.device("cuda")
    libs = parent_libs(*argv)
    if argv[0] == "2e7ac75":
        probe_gaps(libs, dev)
        time_in_turns(libs, dev)
    else:
        probe_leaf(libs["vr_leaf"], dev)


if __name__ == "__main__":
    main()
