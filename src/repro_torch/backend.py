"""Execution plan of the port: which implementation serves each subsystem.

The counterpart of ``repro/backend.py::Backend``:

  =============  ===================================  =======================
  subsystem      fused                                reference
  =============  ===================================  =======================
  ``attention``  hand-written CUDA kernels            plain PyTorch SDPA /
                 (kernels/flash_attention.py,         chunked softmax
                 kernels/flash_attention_bwd.py,      (models/attention.py)
                 kernels/flash_decode.py)
  ``optimizer``  flat m/v/p state, one VR-LAMB        per-leaf tree math
                 kernel pass (kernels/flat_update.py)  (core/vrgd.py)
  ``stats``      flat (g_sum, g2_sum) carry, one      per-leaf tree carry
                 kernel per microbatch + finalize     (core/accumulate.py)
                 (kernels/flat_stats.py)
  =============  ===================================  =======================

Each mode is one of ``"fused" | "reference" | "auto"``.  ``"auto"`` resolves
per tensor: fused for every CUDA tensor, reference for a CPU tensor — so the
CPU tests run the plain paths without a flag, and on a card the kernels run
or their wrappers raise (a card other than Hopper, capability (9, 0), is
refused there; it never gets the plain version).  A fused plan on a CPU
tensor runs the kernel wrappers, which on the CPU compute their plain
version.

Data parallelism
----------------
``Backend.shard(mesh)`` returns a :class:`FlatSpmd` plan (the reference's
``Backend.shard`` / ``FlatSpmd``): the fused VR update and the flat moment
carry then run PER ROW SHARD of the flat buffers on each rank of a
``launch/mesh.py::DataMesh`` (``sharding/rules.py``), with the optimizer
state and the carry holding only the rank's rows.  The carry's sweeps (K3,
K9, K4, K10) are element-wise and need no collective once the gradient is
reduce-scattered into the rank's rows.  The update's per-leaf sums split
into a partials kernel over the shard, one all-reduce of the small
per-leaf accumulator and an apply or compute kernel (kernels/flat_spmd.py);
LAMB and LARS add a second all-reduce of the norm sums before their
trust-ratio epilogue.  The update comes back as the rank's rows; the
trainer gathers it.

On a ``launch/mesh.py::GridMesh`` (the weights' FSDP+TP sharding),
``Backend.shard(mesh, rules, layout)`` returns a :class:`GridSpmd`: the
same pipelines over each rank's local buffer of its spec blocks
(core/layout.py::GridShard), whose per-leaf partial sums are weighted by
the leaf's owner (a replicated leaf counts once) before the all-reduce over
the grid; the gradient needs no collective of its own (the weights'
gathers reduce it in their backward), and the update is the rank's own.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

FUSED = "fused"
REFERENCE = "reference"
AUTO = "auto"
_MODES = (FUSED, REFERENCE, AUTO)
SUBSYSTEMS = ("attention", "optimizer", "stats")
HOPPER = (9, 0)


@functools.lru_cache(maxsize=None)
def device_info(index: int):
    """((major, minor) capability, SM count) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return (props.major, props.minor), props.multi_processor_count


@dataclasses.dataclass(frozen=True)
class Backend:
    """Per-subsystem execution plan (frozen, hashable)."""

    attention: str = AUTO
    optimizer: str = AUTO
    stats: str = AUTO

    def __post_init__(self):
        for sub in SUBSYSTEMS:
            mode = getattr(self, sub)
            if mode not in _MODES:
                raise ValueError(f"Backend.{sub}={mode!r}: must be one of {_MODES}")

    def resolve(self, subsystem: str, device) -> str:
        """The concrete mode ("fused" | "reference") serving ``subsystem``
        for tensors on ``device``."""
        if subsystem not in SUBSYSTEMS:
            raise KeyError(f"unknown subsystem {subsystem!r}; one of {SUBSYSTEMS}")
        mode = getattr(self, subsystem)
        if mode == AUTO:
            return FUSED if torch.device(device).type == "cuda" else REFERENCE
        return mode

    def fused(self, subsystem: str, device) -> bool:
        return self.resolve(subsystem, device) == FUSED

    def describe(self, device) -> dict:
        """The plan resolved for tensors on ``device`` as a plain dict, the
        benchmark records' marker (benchmarks/common.py refuses records
        whose plans differ): each subsystem's mode and the device's name."""
        device = torch.device(device)
        plan = {sub: self.resolve(sub, device) for sub in SUBSYSTEMS}
        plan["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else \
            device.type
        return plan

    @classmethod
    def all_fused(cls) -> "Backend":
        return cls(attention=FUSED, optimizer=FUSED, stats=FUSED)

    @classmethod
    def all_reference(cls) -> "Backend":
        return cls(attention=REFERENCE, optimizer=REFERENCE, stats=REFERENCE)

    def shard(self, mesh, rules=None, layout=None) -> "FlatSpmd":
        """The per-row-shard plan of the flat VR updates on a data ``mesh``;
        on a GridMesh the per-block plan of ``layout``'s buffers under
        ``rules`` (sharding/rules.py; default: the mesh's default rules)."""
        from repro_torch.launch.mesh import GridMesh
        from repro_torch.sharding.rules import Rules

        if isinstance(mesh, GridMesh):
            return GridSpmd(mesh, rules if rules is not None else Rules(mesh=mesh), layout)
        return FlatSpmd(mesh, Rules(mesh=mesh))


class FlatSpmd:
    """Per-shard flat stats sweeps and VR updates on a data mesh.

    The params w are the whole replicated flat buffer, of which a method
    takes this rank's rows (``RowShard.local``: a view, or a zero-padded
    copy on a shard that runs past the layout).  Every other buffer, the
    moments g, g2, the gradient ga, the carries, the state m, v, p (LARS:
    m) and everything returned, is the rank's rows; the carries and the
    state are updated in place.

    The stats sweeps (``moments_accum``, ``g_accum``, ``moments_finalize``,
    ``vmap_moments``: K3, K9, K4, K10 on the rows) are element-wise, so a
    shard's rows are bit for bit the whole-buffer kernel's rows and need no
    collective; ``reduce_rows`` / ``reduce_stack_rows`` sum a rank's whole
    gradient over the mesh into its rows first (the mesh's
    ``reduce_scatter_``).  The updates run the kernels over the rows and
    combine the per-leaf sums with the mesh's all-reduce.  Zero padding rows
    add exact zeros to every per-leaf sum, so padding changes no real row; a
    leaf that straddles two shards has its sums added in another order (~1
    ulp of the leaf scalar)."""

    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = rules
        self._shards = {}

    def shard(self, layout):
        """This rank's RowShard of ``layout``, or None on a one-rank mesh;
        one object per layout, so its maps are built once."""
        if layout not in self._shards:
            self._shards[layout] = self.rules.flat_buffer_shard(layout)
        return self._shards[layout]

    @property
    def batch_mesh(self):
        """The mesh whose ranks split each group's rows."""
        return self.mesh

    def _sum_leaves(self, acc: torch.Tensor, layout) -> torch.Tensor:
        """Per-leaf partial sums of the rank's rows summed over the ranks."""
        return self.mesh.all_reduce_(acc)

    def n_shards(self, layout) -> int:
        sh = self.shard(layout)
        return 1 if sh is None else sh.n_shards

    def supports(self, layout) -> bool:
        """True when the flat buffer of ``layout`` shards over the mesh."""
        return self.n_shards(layout) > 1

    def _local(self, layout, *rows, w=None):
        """(block leaf ids, inverse leaf sizes, this rank's rows of the whole
        params ``w``) of the shard; each buffer of ``rows`` must hold the
        shard's rows."""
        sh = self.shard(layout)
        if any(x.shape[0] != sh.rows for x in rows):
            raise ValueError(f"buffers of {[x.shape[0] for x in rows]} rows where the shard "
                             f"holds {sh.rows}")
        meta = sh.device_meta(rows[0].device)
        return meta["block_leaf_ids"], meta["inv_sizes"], None if w is None else sh.local(w)

    # -- the gradient's rows: the sum over the ranks, times 1/W -------------

    def _padded(self, layout, x: torch.Tensor) -> torch.Tensor:
        """``x`` (n_rows, LANE) with zero rows to W x the shard's rows
        (``x`` itself when the blocks divide)."""
        sh = self.shard(layout)
        rows = sh.n_shards * sh.rows
        if x.shape[0] == rows:
            return x
        out = x.new_zeros((rows, x.shape[1]))
        out[: x.shape[0]] = x
        return out

    def reduce_rows(self, g: torch.Tensor, layout) -> torch.Tensor:
        """This rank's rows of (the ranks' whole flat buffers g summed) x
        1/W, as the data-axis payload is scaled: a new f32 tensor of the
        shard's rows (one reduce-scatter of g, zero-padded to whole
        shards)."""
        from repro_torch.kernels.flat_stats import inv_k

        return self.mesh.reduce_scatter_(self._padded(layout, g)).mul_(inv_k(self.mesh.size))

    def reduce_stack_rows(self, gstack: torch.Tensor, layout) -> torch.Tensor:
        """``reduce_rows`` of each slice of a (k, n_rows, LANE) stack -> a
        new (k, shard rows, LANE) stack."""
        return torch.stack([self.reduce_rows(s, layout) for s in gstack])

    # -- flat-stats sweeps on the rows (element-wise: no collective) ---------

    def moments_accum(self, gs, g2s, g, layout):
        """One microbatch into the rank's (g_sum, g2_sum) rows (K3, in
        place)."""
        from repro_torch.kernels import flat_stats as fs

        return fs.flat_moments_accum(gs, g2s, g)

    def g_accum(self, gs, g, layout):
        """One microbatch into the rank's g-only carry rows (K9, in
        place)."""
        from repro_torch.kernels import flat_stats as fs

        return fs.flat_g_accum(gs, g)

    def moments_finalize(self, gs, g2s, k, layout):
        """The /k of the rank's carry rows (K4, in place) -> (mean,
        sq_mean) rows."""
        from repro_torch.kernels import flat_stats as fs

        return fs.flat_moments_finalize(gs, g2s, k)

    def vmap_moments(self, gstack, k, layout):
        """(mean, sq_mean) rows of a (k, shard rows, LANE) stack of the
        rank's rows (K10)."""
        from repro_torch.kernels import flat_stats as fs

        return fs.flat_vmap_moments(gstack, k)

    # -- optimizer updates (partials kernel -> all-reduce -> apply kernel) ---

    def _racc(self, g, g2, lids, layout, eps):
        from repro_torch.kernels import flat_spmd as fsp

        return self._sum_leaves(
            fsp.leaf_r_partials(g, g2, lids, layout.leaf_slots, gsnr_eps=eps), layout)

    def vr_scale(self, g, ga, g2, layout, *, gamma, eps):
        """(r * ga, r) over this rank's rows."""
        from repro_torch.kernels import flat_spmd as fsp

        lids, inv, _ = self._local(layout, g, ga, g2)
        racc = self._racc(g, g2, lids, layout, eps)
        return fsp.vr_scale_apply(g, ga, g2, racc, lids, inv, gamma=gamma, eps=eps)

    def vr_adam(self, g, ga, g2, m, v, p, w, scal, layout, **hyper):
        """(upd, m', v', p') over this rank's rows; m, v, p are its rows."""
        from repro_torch.kernels import flat_spmd as fsp

        lids, inv, w = self._local(layout, g, ga, g2, w=w)
        racc = self._racc(g, g2, lids, layout, hyper["gsnr_eps"])
        return fsp.vr_adam_apply(g, ga, g2, m, v, p, w, scal, racc, lids, inv, **hyper)

    def vr_lamb(self, g, ga, g2, m, v, p, w, scal, layout, **hyper):
        """(upd, m', v', p') over this rank's rows; m, v, p are its rows."""
        from repro_torch.kernels import flat_spmd as fsp

        lids, inv, w = self._local(layout, g, ga, g2, w=w)
        racc = self._racc(g, g2, lids, layout, hyper["gsnr_eps"])
        u, m, v, p, acc = fsp.vr_lamb_compute(g, ga, g2, m, v, p, w, scal, racc, lids, inv,
                                              **hyper)
        acc = self._sum_leaves(acc, layout)
        return fsp.trust_apply(u, acc, lids, lr=float(scal[0]), lamb=True), m, v, p

    def vr_lars(self, g, ga, g2, m, w, scal, layout, *, mu, wd, trust, eps):
        """(upd, m') over this rank's rows; m (f32) is its rows."""
        from repro_torch.kernels import flat_spmd as fsp

        lids, inv, w = self._local(layout, g, ga, g2, w=w)
        racc = self._racc(g, g2, lids, layout, eps)
        u, acc = fsp.vr_lars_compute(g, ga, g2, w, scal, racc, lids, inv, wd=wd, eps=eps)
        acc = self._sum_leaves(acc, layout)
        return fsp.trust_apply(u, acc, lids, lr=float(scal[0]), lamb=False, m=m, mu=mu,
                               trust=trust)

    def lamb_trust(self, d, w, layout, *, lr, wd):
        """The stale-step LAMB epilogue over this rank's rows: u = d + wd w,
        the shard's per-leaf sums of u^2 and w^2 (plain torch, as the
        reference's ``lamb_trust_flat``), one all-reduce of them, then the
        trust epilogue (``trust_apply``) -> the update rows."""
        from repro_torch.kernels import flat_spmd as fsp

        lids, _, w = self._local(layout, d, w=w)
        u = d + wd * w
        wf = w.float()
        acc = torch.stack((fsp.shard_sums(u * u, lids, layout.leaf_slots),
                           fsp.shard_sums(wf * wf, lids, layout.leaf_slots)))
        acc = self._sum_leaves(acc, layout)
        return fsp.trust_apply(u, acc, lids, lr=float(lr), lamb=True)


class GridSpmd(FlatSpmd):
    """The flat stats sweeps and VR updates on a GridMesh: every buffer is
    the rank's local buffer of its spec blocks (core/layout.py::GridShard
    of ``layout``), the params w included.

    The carries' sweeps (K3, K9, K4) run on the local buffer as they are.
    The gradient of each microbatch arrives summed over the data axis by the
    backward of the weights' gathers (sharding/placement.py), so
    ``reduce_rows`` only scales it by 1/D, in place.  The per-leaf partial
    sums (K13's Sigma r, K16's norm sums) are weighted by each leaf's owner
    and all-reduced over the grid, so a leaf replicated over an axis counts
    once; the trust epilogue applies on the rank's blocks.  The reference
    plan's tree math runs on the rank's local leaves with the same sums
    (``tree_leaf_means``, ``tree_lamb_trust``), and ``norm`` is a global
    norm counted the same way."""

    def __init__(self, mesh, rules, layout):
        super().__init__(mesh, rules)
        self.layout = layout
        self._batch = mesh.axis(rules.dp_axis)

    @property
    def batch_mesh(self):
        return self._batch

    def shard(self, layout):
        from repro_torch.core.layout import GridShard

        if layout not in self._shards:
            specs = [self.rules.leaf_pspec(p, s) for p, s in zip(layout.paths, layout.shapes)]
            self._shards[layout] = GridShard(layout, specs, self.mesh)
        return self._shards[layout]

    def supports(self, layout) -> bool:
        return True

    def _sum_leaves(self, acc: torch.Tensor, layout) -> torch.Tensor:
        own = self.shard(layout).owner_weights(acc.device)
        return self.mesh.all_reduce_(acc * own.to(acc.dtype))

    def reduce_rows(self, g: torch.Tensor, layout) -> torch.Tensor:
        """The rank's gradient blocks x 1/D, in place (the data axis's sum is
        already taken)."""
        from repro_torch.kernels.flat_stats import inv_k

        return g.mul_(inv_k(self._batch.size))

    def reduce_stack_rows(self, gstack, layout):
        from repro_torch.sharding.placement import ROADMAP_REST

        raise NotImplementedError(f"the vmap stats method on a GridMesh ({ROADMAP_REST})")

    def _leaf_totals(self, per_leaf) -> torch.Tensor:
        """(n, n_leaves) f64 per-leaf sums of the rank's blocks -> the sums
        over the grid, each leaf from its owners only."""
        sh = self.shard(self.layout)
        own = torch.as_tensor(sh.owner, dtype=torch.float64, device=per_leaf.device)
        return self.mesh.all_reduce_(per_leaf * own)

    def tree_leaf_means(self, tree) -> list:
        """The whole leaves' means of a tree of the rank's blocks."""
        from repro_torch.core.layout import tree_leaves

        leaves = tree_leaves(tree)
        sums = self._leaf_totals(torch.stack([x.double().sum() for x in leaves])[None])[0]
        return [(sums[i] / n).float() for i, n in enumerate(self.layout.sizes)]

    def tree_lamb_trust(self, d, p, lr, wd):
        """LAMB's trust-scaled update of a tree of the rank's blocks (the
        whole leaves' norms of u = d + wd p and of p)."""
        from repro_torch.core.baselines import _lamb_phi
        from repro_torch.core.layout import tree_leaves, tree_map

        u = tree_map(lambda d_, p_: d_ + wd * p_, d, p)
        sums = self._leaf_totals(torch.stack([
            torch.stack([x.double().square().sum() for x in tree_leaves(t)])
            for t in (u, p)]))
        un, pn = torch.sqrt(sums).float()
        ratio = torch.where((pn > 0) & (un > 0), _lamb_phi(pn) / (un + 1e-12),
                            torch.ones_like(pn))
        scale = iter(-lr * ratio)
        return tree_map(lambda x: next(scale) * x, u)

    def norm(self, x) -> torch.Tensor:
        """The global norm of a FlatBuffer of the rank's blocks or a tree of
        them, each leaf counted once over the grid."""
        from repro_torch.core.layout import is_flat, tree_leaves
        from repro_torch.kernels import flat_spmd as fsp

        if is_flat(x):
            meta = self.shard(self.layout).device_meta(x.data.device)
            per = fsp.shard_sums(x.data.float().square(), meta["block_leaf_ids"],
                                 self.layout.leaf_slots)[: self.layout.n_leaves].double()
        else:
            per = torch.stack([t.double().square().sum() for t in tree_leaves(x)])
        return torch.sqrt(self._leaf_totals(per[None])[0].sum()).float()
