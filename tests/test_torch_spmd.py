"""Port parity of the data-parallel flat pieces: the [g; g^2] payload (K11),
the per-row-shard update kernels (K13-K17) with the trust-ratio epilogue,
and the ``FlatSpmd`` pipelines, without spawning processes.

* K11's plain version against ``repro.kernels.flat_stats.flat_pack_square``
  in interpret mode, bit for bit.
* The plain K13-K17 against ``repro.kernels.flat_spmd``'s functions in
  interpret mode, called directly on the rows of each shard (those functions
  take local shapes, so no mesh is needed) of the hostile layout split over
  W = 1, 2 and 3 shards: 19 blocks, so W = 2 and 3 pad the last shard, and
  leaf 4 (9 blocks) straddles the W = 2 boundary, leaf 3 (5 blocks) the
  first W = 3 boundary.  The per-leaf partials are summed across the shards
  in numpy (the reference's lane rows) and in torch (the port's one f32 per
  leaf) in place of the all-reduce.
* The port's ``FlatSpmd`` pipelines with W ranks as threads of this process
  (``_ThreadMesh``: the all-reduce adds the ranks' tensors in rank order),
  their row shards put together, against the port's single-card
  ``flat_vr_*_ref`` on the whole buffers.

Tolerances are tests/test_torch_optim.py's for K5-K8: ``oracle.tol_for
(float32)`` (atol 2e-5, rtol 2e-4; the per-leaf sums run in another order),
bf16 state one bf16 ulp, padded rows equal row for row; the payload exact.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layout import ParamLayout as JLayout
from repro.kernels import flat_spmd as jsp
from repro.kernels import flat_stats as jfs
from repro.kernels import flat_update as jfu
from repro_torch.backend import Backend
from repro_torch.core.layout import FlatBuffer, ParamLayout, RowShard, pad_mask, tree_map
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels import flat_spmd as fsp
from repro_torch.kernels import flat_stats as fs
from repro_torch.kernels import flat_update as fu
from repro_torch.kernels import ops
from repro_torch.sharding import Rules
from test_torch_optim import (ADAM_HYPER, ADAM_SCAL, BF16_STATE, LARS_HYPER, LARS_SCAL, TOL,
                              _flat_inputs, _tree)

SHARDS = [1, 2, 3]
STATE_DTYPES = ["float32", "bfloat16"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _assert_rows(name, got, want, mask, tol):
    """Allclose everywhere, and the zero rows (a leaf's tail, the padding
    blocks) equal row for row."""
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, err_msg=name, **tol)
    np.testing.assert_array_equal(got[~mask], want[~mask], err_msg=f"{name} (zero rows)")


@pytest.mark.parametrize("layout", ["hostile", "bert-large"])
def test_pack_square_matches_reference(layout):
    tree = _tree(layout)
    tl = ParamLayout.for_tree(tree)
    g = _flat_inputs(tl, 2)["g"]
    want = _np(jfs.flat_pack_square(jnp.asarray(g), JLayout.for_tree(tree), interpret=True))
    got = fs.flat_pack_square(_t(g))
    assert got.shape == (2, tl.n_rows, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K13-K17 per shard against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_runs():
    """{W: (shards, per-shard inputs, JAX outputs)} on the hostile layout;
    the JAX kernels run once per W, in interpret mode."""
    tree = _tree("hostile")
    jl, tl = JLayout.for_tree(tree), ParamLayout.for_tree(tree)
    x = _flat_inputs(tl, 3)
    invsz = jnp.asarray(jl.leaf_inv_sizes())
    lscal, ascal = jfu._scal8(*LARS_SCAL), jfu._scal8(*ADAM_SCAL)
    out = {}
    for w_ in SHARDS:
        shards = [RowShard(tl, w_, s) for s in range(w_)]
        loc = [{k: sh.local(_t(v)).numpy() for k, v in x.items()} for sh in shards]
        lids = [jnp.asarray(sh.block_leaf_ids()[:, None]) for sh in shards]
        j = [{k: jnp.asarray(v) for k, v in d.items() if k != "mask"} for d in loc]
        parts = [_np(jsp.leaf_r_partials(a["g"], a["g2"], ids, jl, gsnr_eps=1e-12,
                                         interpret=True)) for a, ids in zip(j, lids)]
        racc = jnp.asarray(np.sum(np.stack(parts), axis=0, dtype=np.float32))
        want = {"partials": parts, "scale": [], "lars": []}
        for a, ids in zip(j, lids):
            want["scale"].append(tuple(_np(o) for o in jsp.vr_scale_apply(
                a["g"], a["ga"], a["g2"], racc, ids, invsz, jl, gamma=0.1, eps=1e-12,
                interpret=True)))
            want["lars"].append(tuple(_np(o) for o in jsp.vr_lars_compute(
                a["g"], a["ga"], a["g2"], a["w"], lscal, racc, ids, invsz, jl,
                wd=LARS_HYPER["wd"], eps=LARS_HYPER["eps"], interpret=True)))
            for sd in STATE_DTYPES:
                mvp = [a[k].astype(sd) for k in "mvp"]
                for kind, fn in (("adam", jsp.vr_adam_apply), ("lamb", jsp.vr_lamb_compute)):
                    want.setdefault(f"{kind}-{sd}", []).append(tuple(_np(o) for o in fn(
                        a["g"], a["ga"], a["g2"], *mvp, a["w"], ascal, racc, ids, invsz, jl,
                        state_dtype=sd, interpret=True, **ADAM_HYPER)))
        out[w_] = (shards, loc, want)
    return out


def _port_racc(shards, loc):
    """The port's K13 partials of every shard and their sum in rank order."""
    parts = [fsp.leaf_r_partials(_t(a["g"]), _t(a["g2"]), sh.device_meta("cpu")["block_leaf_ids"],
                                 sh.layout.leaf_slots, gsnr_eps=1e-12)
             for sh, a in zip(shards, loc)]
    return parts, sum(parts[1:], parts[0].clone())


def test_hostile_shardings_pad_and_straddle():
    """The geometry the per-shard cases rely on."""
    tl = ParamLayout.for_tree(_tree("hostile"))
    assert tl.n_blocks == 19
    first_block = np.cumsum((0,) + tuple(r // 64 for r in tl.leaf_rows))
    for w_ in (2, 3):
        sh = RowShard(tl, w_, 0)
        assert sh.pad_blocks > 0
        edge = sh.n_blocks  # the first shard boundary, in blocks
        assert any(a < edge < b for a, b in zip(first_block[:-1], first_block[1:]))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_leaf_r_partials_match_reference(n_shards, shard_runs):
    shards, loc, want = shard_runs[n_shards]
    parts, _ = _port_racc(shards, loc)
    for s, (got, w_) in enumerate(zip(parts, want["partials"])):
        assert got.shape == (shards[0].layout.leaf_slots,)
        np.testing.assert_allclose(got.numpy(), w_.sum(axis=1), err_msg=f"shard {s}", **TOL)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_vr_scale_apply_matches_reference(n_shards, shard_runs):
    shards, loc, want = shard_runs[n_shards]
    _, racc = _port_racc(shards, loc)
    for s, (sh, a) in enumerate(zip(shards, loc)):
        meta = sh.device_meta("cpu")
        sg, r = fsp.vr_scale_apply(_t(a["g"]), _t(a["ga"]), _t(a["g2"]), racc,
                                   meta["block_leaf_ids"], meta["inv_sizes"], gamma=0.1, eps=1e-12)
        _assert_rows(f"sg shard {s}", sg, want["scale"][s][0], a["mask"], TOL)
        _assert_rows(f"r shard {s}", r, want["scale"][s][1], a["mask"], TOL)
        assert (r.numpy()[~a["mask"]] == np.float32(0.1)).all()


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
@pytest.mark.parametrize("kind", ["adam", "lamb"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_vr_adam_and_lamb_per_shard_match_reference(n_shards, kind, state_dtype, shard_runs):
    """K15 (VR-Adam apply) and K16 (VR-LAMB compute, with its norm partials
    and the trust epilogue from their sum)."""
    shards, loc, want = shard_runs[n_shards]
    _, racc = _port_racc(shards, loc)
    sd = getattr(torch, state_dtype)
    fn = fsp.vr_adam_apply if kind == "adam" else fsp.vr_lamb_compute
    accs, us = [], []
    for s, (sh, a) in enumerate(zip(shards, loc)):
        meta = sh.device_meta("cpu")
        m, v, p = (_t(a[k]).to(sd, copy=True) for k in "mvp")  # a is the shared input
        got = fn(_t(a["g"]), _t(a["ga"]), _t(a["g2"]), m, v, p, _t(a["w"]), ADAM_SCAL, racc,
                 meta["block_leaf_ids"], meta["inv_sizes"], state_dtype=state_dtype, **ADAM_HYPER)
        w_ = want[f"{kind}-{state_dtype}"][s]
        _assert_rows(f"{kind} u/upd shard {s}", got[0], w_[0], a["mask"], TOL)
        state_tol = BF16_STATE if state_dtype == "bfloat16" else TOL
        for i, name in enumerate("mvp"):
            assert got[1 + i].dtype == sd
            _assert_rows(f"{kind} {name}' shard {s}", got[1 + i], w_[1 + i], a["mask"], state_tol)
        if kind == "lamb":
            np.testing.assert_allclose(got[4].numpy(), np.stack([w_[4].sum(1), w_[5].sum(1)]),
                                       err_msg=f"lamb norm partials shard {s}", **TOL)
            accs.append(got[4])
            us.append((got[0], w_[0], w_[4], w_[5]))
    if kind == "lamb":  # the epilogue from the summed partials
        acc = sum(accs[1:], accs[0].clone())
        uacc = jnp.asarray(np.sum([u[2] for u in us], axis=0, dtype=np.float32))
        wacc = jnp.asarray(np.sum([u[3] for u in us], axis=0, dtype=np.float32))
        ratio = _np(jsp.trust_from_partials(uacc, wacc, numer_is_phi=True, trust=0.0))
        for s, (sh, (u, ju, _, _)) in enumerate(zip(shards, us)):
            ids = sh.device_meta("cpu")
            upd = fsp.trust_apply(u.clone(), acc, ids["block_leaf_ids"], lr=ADAM_SCAL[0],
                                  lamb=True)
            jupd = -np.float32(ADAM_SCAL[0]) * ratio[np.repeat(sh.block_leaf_ids(), 64)][:, None] * ju
            _assert_rows(f"lamb upd shard {s}", upd, jupd, loc[s]["mask"], TOL)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_vr_lars_compute_matches_reference(n_shards, shard_runs):
    """K17 with its norm partials, then the trust epilogue (m', upd)."""
    shards, loc, want = shard_runs[n_shards]
    _, racc = _port_racc(shards, loc)
    got = []
    for s, (sh, a) in enumerate(zip(shards, loc)):
        meta = sh.device_meta("cpu")
        u, acc = fsp.vr_lars_compute(_t(a["g"]), _t(a["ga"]), _t(a["g2"]), _t(a["w"]), LARS_SCAL,
                                     racc, meta["block_leaf_ids"], meta["inv_sizes"],
                                     wd=LARS_HYPER["wd"], eps=LARS_HYPER["eps"])
        ju, juacc, jwacc = want["lars"][s]
        _assert_rows(f"lars u shard {s}", u, ju, a["mask"], TOL)
        np.testing.assert_allclose(acc.numpy(), np.stack([juacc.sum(1), jwacc.sum(1)]),
                                   err_msg=f"lars norm partials shard {s}", **TOL)
        got.append((u, acc))
    acc = sum((a for _, a in got[1:]), got[0][1].clone())
    uacc = jnp.asarray(np.sum([w_[1] for w_ in want["lars"]], axis=0, dtype=np.float32))
    wacc = jnp.asarray(np.sum([w_[2] for w_ in want["lars"]], axis=0, dtype=np.float32))
    ratio = _np(jsp.trust_from_partials(uacc, wacc, numer_is_phi=False,
                                        trust=LARS_HYPER["trust"]))
    for s, (sh, (u, _)) in enumerate(zip(shards, got)):
        ids = sh.device_meta("cpu")
        m = _t(loc[s]["m"]).clone()
        upd, m2 = fsp.trust_apply(u, acc, ids["block_leaf_ids"], lr=LARS_SCAL[0], lamb=False, m=m,
                                  mu=LARS_HYPER["mu"], trust=LARS_HYPER["trust"])
        jm = (np.float32(LARS_HYPER["mu"]) * loc[s]["m"]
              + ratio[np.repeat(sh.block_leaf_ids(), 64)][:, None] * want["lars"][s][0])
        _assert_rows(f"lars m' shard {s}", m2, jm, loc[s]["mask"], TOL)
        _assert_rows(f"lars upd shard {s}", upd, -np.float32(LARS_SCAL[0]) * jm, loc[s]["mask"],
                     TOL)


# ---------------------------------------------------------------------------
# FlatSpmd pipelines, W ranks as threads, against the single-card update
# ---------------------------------------------------------------------------


class _Group:
    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=60)


class _ThreadMesh:
    """Rank ``rank`` of W threads of one process, standing in for a
    DataMesh: the collectives exchange tensors through shared slots."""

    def __init__(self, group: _Group, rank: int):
        self.group, self.rank, self.size = group, rank, group.size

    def _exchange(self, t):
        g = self.group
        g.slots[self.rank] = t.clone()
        g.barrier.wait()
        got = list(g.slots)
        g.barrier.wait()
        return got

    def all_reduce_(self, t):
        got = self._exchange(t)
        return t.copy_(sum(got[1:], got[0].clone()))

    def all_gather(self, out, t):
        return out.copy_(torch.cat(self._exchange(t)))


def _threads(n, fn):
    """fn(mesh) on n thread ranks; returns their results in rank order."""
    group, out, errors = _Group(n), [None] * n, []

    def run(rank):
        try:
            out[rank] = fn(_ThreadMesh(group, rank))
        except BaseException as e:  # reported below, after every thread ended
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a thread rank did not finish"
    if errors:
        raise errors[0]
    return out


def _rows(parts, layout):
    """The ranks' row shards put together, padding dropped."""
    return torch.cat(parts)[: layout.n_rows]


@pytest.mark.parametrize("opt", ["scale", "adam", "lamb", "lars"])
@pytest.mark.parametrize("layout,n_shards", [("hostile", 2), ("hostile", 3), ("hostile", 4),
                                            ("bert-large", 4)])
def test_flat_spmd_pipelines_match_single_card(layout, n_shards, opt):
    tl = ParamLayout.for_tree(_tree(layout))
    x = {k: _t(v) for k, v in _flat_inputs(tl, 4).items()}
    mask = x.pop("mask").numpy()
    g, ga, g2, w = x["g"], x["ga"], x["g2"], x["w"]

    def rank(mesh):
        plan = Backend.all_fused().shard(mesh)
        sh = plan.shard(tl)
        assert plan.supports(tl) and sh.n_shards == n_shards and sh.index == mesh.rank
        local = {k: sh.local(x[k]).clone() for k in ("m", "v", "p", "g", "ga", "g2")}
        gl, gal, g2l = local["g"], local["ga"], local["g2"]
        if opt == "scale":
            return plan.vr_scale(gl, gal, g2l, tl, gamma=0.1, eps=1e-12)
        if opt == "lars":
            return plan.vr_lars(gl, gal, g2l, local["m"], w, LARS_SCAL, tl, **LARS_HYPER)
        fn = plan.vr_adam if opt == "adam" else plan.vr_lamb
        return fn(gl, gal, g2l, local["m"], local["v"], local["p"], w, ADAM_SCAL, tl,
                  state_dtype="float32", **ADAM_HYPER)

    parts = _threads(n_shards, rank)
    got = [_rows([p[i] for p in parts], tl) for i in range(len(parts[0]))]
    if opt == "scale":
        want = fu.flat_vr_scale_ref(g, ga, g2, tl, gamma=0.1, eps=1e-12)
    elif opt == "lars":
        want = fu.flat_vr_lars_ref(g, ga, g2, x["m"].clone(), w, LARS_SCAL, tl, **LARS_HYPER)
    else:
        fn = fu.flat_vr_adam_ref if opt == "adam" else fu.flat_vr_lamb_ref
        want = fn(g, ga, g2, *(x[k].clone() for k in "mvp"), w, ADAM_SCAL, tl, **ADAM_HYPER)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_rows(f"{opt} output {i}", a, b.numpy(), mask, TOL)


def test_rules_shard_rows_like_the_reference():
    """Rows shard over the data axis whenever the mesh has more than one
    rank; blocks split evenly with zero blocks of leaf 0 at the end."""
    tl = ParamLayout.for_tree(_tree("hostile"))  # 19 blocks, 1216 rows
    mesh = type("M", (), {"size": 4, "rank": 3})()
    sh = Rules(mesh).flat_buffer_shard(tl)
    assert (sh.n_blocks, sh.pad_blocks, sh.rows, sh.row_start, sh.real_rows) == (5, 1, 320, 960,
                                                                                256)
    assert sh.block_leaf_ids().tolist() == tl.block_leaf_ids()[15:, 0].tolist() + [0]
    mesh.size, mesh.rank = 3, 2  # 19 blocks over 3 ranks: 7 each, 2 padding
    sh = Rules(mesh).flat_buffer_shard(tl)
    assert (sh.n_blocks, sh.pad_blocks, sh.row_start, sh.real_rows) == (7, 2, 896, 320)
    assert Backend.all_fused().shard(mesh).supports(tl)
    mesh.size, mesh.rank = 1, 0  # one rank: the buffer stays whole
    assert Rules(mesh).flat_buffer_shard(tl) is None
    assert not Backend.all_fused().shard(mesh).supports(tl)
    # local rows: a view inside the layout, a zero-padded copy past it
    buf = torch.arange(tl.n_rows * 128, dtype=torch.float32).view(tl.n_rows, 128)
    first, last = RowShard(tl, 4, 0), RowShard(tl, 4, 3)
    assert first.local(buf).data_ptr() == buf.data_ptr()
    tail = last.local(buf)
    assert torch.equal(tail[:256], buf[960:]) and not tail[256:].any()
    fb = tree_map(lambda t: t * 2, FlatBuffer(tail, tl, last))
    assert fb.shard is last and "shard=3/4" in repr(fb)


def test_row_shards_gather_back_to_the_buffer():
    tl = ParamLayout.for_tree(_tree("bert-large"))
    buf = torch.randn(tl.n_rows, 128) * pad_mask(tl)
    parts = _threads(4, lambda mesh: RowShard(tl, 4, mesh.rank).gather(
        RowShard(tl, 4, mesh.rank).local(buf), mesh))
    for p in parts:
        assert torch.equal(p, buf)


def test_shard_batch_takes_the_ranks_rows():
    batch = {"tokens": torch.arange(24).view(8, 3), "mask": torch.ones(8, 3)}
    for rank in range(4):
        mesh = type("M", (), {"size": 4, "rank": rank})()
        got = shard_batch(batch, mesh)
        assert torch.equal(got["tokens"], batch["tokens"][2 * rank: 2 * rank + 2])
    with pytest.raises(ValueError, match="not divisible over 3 ranks"):
        shard_batch(batch, type("M", (), {"size": 3, "rank": 0})())


def test_sharded_state_and_replicated_plan_disagree_loudly():
    """A row-shard state handed to an update whose plan replicates the
    buffer (or the reverse) raises instead of mixing shapes."""
    from repro_torch.core.gsnr import GradStats

    tl = ParamLayout.for_tree(_tree("hostile"))
    x = {k: _t(v) for k, v in _flat_inputs(tl, 5).items() if k != "mask"}
    sh = RowShard(tl, 2, 0)
    stats = GradStats(FlatBuffer(x["g"], tl), FlatBuffer(x["g2"], tl), 2)
    state = {"step": 0, "pt": 0, **{k: FlatBuffer(sh.local(x[k]).clone(), tl, sh) for k in "mvp"}}
    with pytest.raises(ValueError, match="the state is a row shard but the plan replicates"):
        ops.vr_lamb_update(FlatBuffer(x["ga"], tl), state, stats, 1e-3, *ADAM_HYPER.values(),
                           FlatBuffer(x["w"], tl))


def test_data_mesh_backend_is_explicit():
    from repro_torch.launch.mesh import init_data_mesh

    with pytest.raises(ValueError, match="must be one of"):
        init_data_mesh("mpi", "cpu")
    with pytest.raises(ValueError, match="nccl backend reduces CUDA tensors only"):
        init_data_mesh("nccl", "cpu")

