"""Training loop: the train step with k-group GSNR statistics.

Port of ``repro/train/trainer.py::make_train_step`` (both GSNR sources,
with or without a data mesh), ``init_state`` and ``train_loop``.  One fresh
VR step is the paper's Algorithm 1/3/5 end to end:

  1. split the batch into k microbatches; forward + backward of each, its
     gradient folded into the (g_sum, g2_sum) carry; then /k
     (core/accumulate.py; with ``stats_method="vmap"`` one batched forward
     and backward over the k groups and one reduction of their stack);
  2. clip the MEAN gradient to the global norm ``grad_clip`` -> ga (the
     GSNR ratio still reads the raw moments);
  3. the VR optimizer: GSNR -> normalize -> clip -> the scaled update
     (core/vrgd.py);
  4. params += update, in place on the flat parameter buffer.

A stale VR step (``with_stats=False``; ``train_loop`` runs one on every step
but each ``gsnr_refresh``-th, for vr_adam and vr_lamb) carries the mean
gradient only and hands the optimizer ``stats=None``.  The baselines (sgd,
momentum, adam, lars, lamb) take one backward over the whole batch
(``grad_only``) and tree math.

On the fused plan steps 1 and 3 run the kernels (K1 forward and remat
forward, K2 backward, K3 per microbatch and K4, or K9 per microbatch on a
stale step; under "vmap" K1 twice and K2 once per layer for all k groups,
then K10, or a plain mean on a stale step; K5, K6, K7 or K8 for the
update); on the reference plan their
plain PyTorch versions.  The stats and optimizer subsystems may resolve
differently (a mixed plan, single-device only, as in the reference): the
moments cross the flat boundary at the optimizer (core/vrgd.py), and the
update is added in the optimizer's form.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.

Data parallelism (``mesh=``, a launch/mesh.py::DataMesh; the reference's
``pjit`` step with its ``_shard_plan``): every rank holds the same params
and the global batch, and takes its rows of it.
  * ``gsnr_source="data_axis"`` (the reference's ``use_device_stats``):
    one backward over the rank's rows; one all-reduce of the [g; g^2]
    payload (K11 on the fused plan) gives every rank the statistics of k = W
    groups (core/distributed.py), of which the fused plan keeps the rank's
    rows.
  * The microbatch source (and ``data_axis`` without a mesh, as in the
    reference): each of the k microbatches is one backward over the rank's
    rows of it, its loss divided by the group's global live count / W
    (train/loss.py), the flat gradient reduce-scattered x 1/W, and K3 folds
    the rank's rows into the carry's rows, K4 after the last (the vmap
    method: one vmapped backward over the rank's rows of the k groups, the
    stack reduce-scattered, K10 on its rows).  A stale step under a mesh
    always takes this source with K9 on the rows, as the reference does.
  * On the fused plan the VR update runs per row shard (``Backend.shard``:
    K13, an all-reduce, K14-K17, the optimizer state holding the rank's
    rows; a stale step's chain on the rows, LAMB's trust ratio from one
    all-reduce of per-leaf partials) and the ranks' update rows are gathered
    and added to every rank's params, so the params stay identical;
    grad_norm and update_norm come from the shards' sums of squares and one
    scalar all-reduce each.  The reference plan all-reduces the gradient
    (or the per-leaf stack) and runs the tree math on every rank, and so do
    the baselines on either plan (one all-reduce of the flat gradient x
    1/W).

FSDP + TP of the model's weights (``mesh=``, a launch/mesh.py::GridMesh of
D x M ranks; the reference's GSPMD placement by its sharding rules): each
rank holds its spec block of every leaf (core/layout.py::GridParams) and
the forward gathers the weights on use (models/transformer.py::
forward_grid, sharding/placement.py).  Every optimizer runs there, on both
plans and both GSNR sources, with either stats method:
  * the microbatch source: the data ranks split each group's rows, the
    backward leaves each rank's blocks of the gradient summed over the data
    axis (x 1/D), and the carry (K3/K9, K4) runs on the rank's local
    buffer; the vmap method takes the k groups through one vmapped
    backward (each layer's weights gathered once for all k, the groups
    without remat) and K10 over the (k, rows, 128) stack of its blocks;
  * the data-axis source: k = D, each data rank's whole gradient of its
    rows squared after the model-axis sums and before the data-axis sum,
    K11 once and one reduce-scatter of the payload into the rank's blocks
    (core/distributed.py);
  * the baselines: one backward, the rank's blocks x 1/D, tree math on the
    blocks with LARS's and LAMB's trust ratios from the whole leaves'
    norms;
  * the VR updates (K13, an all-reduce, then K14, K15, K16 or K17; LAMB and
    LARS a second all-reduce and ``trust_apply``; a stale step's chain) on
    the rank's local buffer, whose per-leaf sums count a replicated leaf
    once (backend.py::GridSpmd), and the reference plan's tree math on the
    rank's blocks with the same sums.
The update is added to the rank's own blocks in place; nothing is gathered
after the step.  grad_norm, update_norm, gsnr/* and noise/* come from the
blocks and one all-reduce each.  A mixture of experts runs with its expert
weights sharded by the reference's expert rule (models/moe.py::
apply_moe_grid); only the block kinds of ROADMAP A9.3
(sharding/placement.py::Placement) raise there.

``noise_scale=True`` adds the gradient-noise-scale readings of a fresh VR
step (core/noise_scale.py: plain reductions over the moments the step has
built, so the step launches no more kernels) and the live LR; ``eval_loss``
weighs each eval batch by its live tokens.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Config
from repro_torch.core import noise_scale as ns
from repro_torch.core.accumulate import grad_only, grad_stats
from repro_torch.core.distributed import device_grad_stats_fn
from repro_torch.core.gsnr import gsnr_scale, gsnr_summary, gsnr_summary_rows
from repro_torch.core.layout import (FlatBuffer, FlatParams, GridParams, is_flat, stack_groups,
                                     tree_leaves, tree_map)
from repro_torch.core.schedule import make_schedule
from repro_torch.core.vrgd import make_optimizer
from repro_torch.launch.mesh import GridMesh
from repro_torch.models import init_params
from repro_torch.models.transformer import model_layout
from repro_torch.sharding.placement import Placement, block_slices
from repro_torch.sharding.rules import Rules
from repro_torch.serve.engine import resolve_device
from repro_torch.train.loss import make_loss_fn
from repro_torch.train.train_state import TrainState


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (the zero tail of
    a flat buffer adds nothing).  A FlatBuffer of a rank's rows sums its
    rows, then one scalar all-reduce over ``mesh`` adds the ranks'."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    if getattr(tree, "shard", None) is not None:
        sq = mesh.all_reduce_(sq[None])[0]
    return torch.sqrt(sq)


def _to_device(batch: Dict, device) -> Dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device_of(device, mesh):
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
    return resolve_device(mesh.device)


def _shard_plan(bk, mesh):
    """The per-row-shard plan of the flat update on ``mesh`` (None without
    one)."""
    return None if mesh is None else bk.shard(mesh)


def grid_plan(cfg: Config, mesh: GridMesh):
    """(Placement, GridSpmd) of ``cfg``'s model on the GridMesh: the
    reference's rules (``cfg.parallel``'s axes and ``fsdp``) over the
    model's stacked layout."""
    pc = cfg.parallel
    if (pc.dp_axis, pc.tp_axis) != tuple(mesh.axis_names):
        raise ValueError(f"the config's axes ({pc.dp_axis!r}, {pc.tp_axis!r}) are not the "
                         f"grid's {mesh.axis_names}")
    rules = Rules(mesh=mesh, fsdp=pc.fsdp, tp_axis=pc.tp_axis, dp_axis=pc.dp_axis,
                  pod_axis=pc.pod_axis)
    layout = model_layout(cfg.model)
    spmd = pc.backend.shard(mesh, rules, layout)
    shard = spmd.shard(layout)
    pl = Placement(cfg.model, rules, mesh, dict(zip(layout.paths, shard.specs)),
                   dict(zip(layout.paths, layout.shapes)))
    return pl, spmd


def make_train_step(
    cfg: Config,
    loss_fn: Optional[Callable] = None,
    log_gsnr: bool = False,
    device=None,
    mesh=None,
    noise_scale: bool = False,
) -> Tuple[Callable, object]:
    """Returns (train_step(state, batch, with_stats=True) -> (state, metrics),
    optimizer).

    ``batch`` is a dict of (B, ...) arrays or tensors (moved to the device;
    under a mesh, the global batch, of which each rank takes its rows);
    ``with_stats=False`` makes a VR step stale.  Metrics are 0-dim tensors:
    loss, grad_norm, update_norm, the loss's own (ce, pack_efficiency) and,
    with ``log_gsnr`` on a fresh VR step, gsnr/mean, gsnr/min and
    gsnr/frac_floor; under a mesh they are the same on every rank.  On a
    GridMesh ``state.params`` is the rank's GridParams and ``loss_fn`` must
    run the grid's forward (``make_loss_fn(cfg, placement)``, the default);
    every optimizer, source and stats method runs (the module note).

    ``noise_scale=True`` adds ``lr`` (a float: the schedule at
    ``state.step`` for the effective batch ``cfg.global_batch``) to every
    step and, on a fresh VR step, noise/g2_small, noise/g2_big,
    noise/tr_sigma, noise/g2 and noise/b_simple, with B_small = B/k and
    B_big = B: from the moment carry on the microbatch source (its rows
    summed over the ranks under a mesh, its blocks' per-leaf sums from
    their owners on a GridMesh), from the reduced payload's two sums on
    the data-axis source."""
    opt_cfg = cfg.optimizer
    device = _device_of(device, mesh)
    grid = isinstance(mesh, GridMesh)
    bk = cfg.parallel.backend
    if mesh is not None and bk.resolve("stats", device) != bk.resolve("optimizer", device):
        raise NotImplementedError(
            "a plan whose stats and optimizer subsystems resolve to different modes "
            f"({bk.resolve('stats', device)} / {bk.resolve('optimizer', device)}) runs on one "
            "device only: under a mesh the flat carry and update hold a rank's rows, which "
            "do not cross into the tree form (the reference's mixed plans are single-device)")
    if grid:  # the rank's blocks; per-leaf sums count a replicated leaf once
        placement, spmd = grid_plan(cfg, mesh)
        norm, rows_mesh = spmd.norm, mesh.axis(mesh.axis_names)
    else:
        placement, spmd = None, _shard_plan(bk, mesh)
        norm, rows_mesh = (lambda t: global_norm(t, mesh)), mesh
    opt = make_optimizer(opt_cfg, backend=bk, effective_batch=cfg.global_batch, spmd=spmd)
    loss_fn = loss_fn or make_loss_fn(cfg, placement=placement)
    if grid and getattr(loss_fn, "placement", None) is None:
        raise ValueError("on a GridMesh the loss function must run the grid's forward: "
                         "train/loss.py::make_loss_fn(cfg, placement)")
    is_vr = opt_cfg.is_vr
    # the reference's use_device_stats: data_axis without a mesh falls back
    # to the microbatch source
    device_stats = None
    if is_vr and opt_cfg.gsnr_source == "data_axis" and mesh is not None:
        device_stats = device_grad_stats_fn(loss_fn, mesh, backend=bk,
                                            with_noise_terms=noise_scale, spmd=spmd)
    lr_fn = make_schedule(opt_cfg, effective_batch=cfg.global_batch) if noise_scale else None
    # the VR optimizers return FlatBuffers on the fused optimizer plan (a tree
    # gradient from the reference stats plan is packed on entry) and trees on
    # the reference plan (a flat gradient unpacked on entry); the baselines are
    # tree math on either plan (core/baselines.py)
    flat_form = is_vr and bk.fused("optimizer", device)

    def train_step(state: TrainState, batch, with_stats: bool = True
                   ) -> Tuple[TrainState, Dict]:
        flat = state.params  # a FlatParams, or a GridParams on a GridMesh
        batch = _to_device(batch, flat.device)
        noise = None
        if is_vr and with_stats and device_stats is not None:
            loss, aux, stats, *terms = device_stats(flat, batch)
            if noise_scale:
                noise = ns.estimate_from_terms(g2_small=terms[0][1], g2_big=terms[0][0],
                                               b_small=cfg.global_batch / stats.k,
                                               b_big=cfg.global_batch)
        elif is_vr:  # the microbatch source; a stale step under a mesh too
            loss, aux, stats = grad_stats(loss_fn, flat, batch, opt_cfg.k,
                                          method=opt_cfg.stats_method, squares=with_stats,
                                          backend=bk, spmd=spmd)
            if with_stats and noise_scale:
                with torch.no_grad():
                    noise = ns.estimate(stats, b_small=cfg.global_batch / stats.k,
                                        b_big=cfg.global_batch, mesh=mesh,
                                        grid=spmd if grid else None)
        else:
            loss, aux, grads = grad_only(loss_fn, flat, batch, spmd=spmd)
            stats = None
        if is_vr:
            grads = stats.mean
            if not with_stats:
                stats = None
        gnorm = norm(grads)
        if opt_cfg.grad_clip > 0:
            scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        w = FlatBuffer(flat.data, flat.layout, getattr(flat, "shard", None)) if flat_form \
            else flat.stacked()
        with torch.no_grad():
            upd, opt_state = opt.update(grads, state.opt_state, w, stats=stats)
            unorm = norm(upd)
            shard = getattr(upd, "shard", None)
            if shard is None or grid:  # the whole params, or the rank's own blocks
                tree_map(lambda p, u: p.add_(u), w, upd)
            else:  # the rank's rows: every rank's rows gathered
                flat.data.add_(shard.gather(upd.data, mesh))
        metrics = {"loss": loss, "grad_norm": gnorm, "update_norm": unorm, **aux}
        if log_gsnr and stats is not None:
            with torch.no_grad():
                if grid and not is_flat(stats.mean):  # the reference plan's trees of blocks
                    pack = lambda t: FlatBuffer(flat.local_layout.pack(t), flat.layout,
                                                flat.shard)
                    stats = stats._replace(mean=pack(stats.mean), sq_mean=pack(stats.sq_mean))
                if getattr(stats.mean, "shard", None) is not None:
                    metrics.update(gsnr_summary_rows(stats, opt_cfg.gamma, rows_mesh))
                else:
                    metrics.update(gsnr_summary(gsnr_scale(stats, opt_cfg.gamma),
                                                opt_cfg.gamma))
        if noise_scale:
            metrics["lr"] = lr_fn(state.step)
            if noise is not None:
                metrics.update({f"noise/{name}": getattr(noise, name) for name in
                                ("g2_small", "g2_big", "tr_sigma", "g2", "b_simple")})
        # _replace keeps the fields the step does not own (autoscale's k)
        return state._replace(opt_state=opt_state, step=opt_state["step"]), metrics

    return train_step, opt


def init_state(cfg: Config, params: Optional[Dict] = None, device=None,
               mesh=None) -> TrainState:
    """TrainState with the params (the port's tree; default: seeded random
    init from ``cfg.seed``) copied into a FlatParams on ``device``, and the
    optimizer state of the plan ``cfg.parallel.backend`` resolves to.  Under
    a mesh every rank takes rank 0's params (a broadcast), and a sharded
    flat state holds the rank's rows.

    On a GridMesh every rank takes the same whole params (the port's tree,
    the reference's stacked tree of numpy arrays as ``jax.device_get`` of
    its ``init_params`` gives it, or the seeded init drawn on the mesh's
    device) and keeps only its blocks (a GridParams on the mesh's device);
    the optimizer state holds the rank's blocks."""
    device = _device_of(device, mesh)
    if isinstance(mesh, GridMesh):
        return _grid_init(cfg, params, mesh, device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = init_params(cfg.model, gen, device=device)
    flat = FlatParams(params, cfg.model.n_groups(), device=device)
    if mesh is not None:
        with torch.no_grad():
            mesh.broadcast_(flat.data)
    bk = cfg.parallel.backend
    opt = make_optimizer(cfg.optimizer, backend=bk, effective_batch=cfg.global_batch,
                         spmd=_shard_plan(bk, mesh))
    return TrainState(flat, opt.init(flat), 0)


def grid_params(cfg: Config, params, mesh: GridMesh, device=None):
    """(the rank's GridParams of ``params``, the plan's GridSpmd): the
    rank's blocks of every leaf (``params``: the port's or the reference's
    tree, whole, on any device; None draws ``init_params`` from the
    config's seed) in one flat f32 buffer on ``device`` (default: the
    mesh's)."""
    device = _device_of(device, mesh)
    pl, spmd = grid_plan(cfg, mesh)
    shard = spmd.shard(spmd.layout)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = init_params(cfg.model, gen, device=device)
    if isinstance(params.get("groups"), list):  # the port's tree
        params = stack_groups(params)
    leaves = spmd.layout.check_tree(params, "init_state params")
    data = shard.zeros(torch.float32, device)
    coords, sizes = dict(mesh.coords), dict(mesh.shape)
    for view, leaf, spec in zip(shard.local_layout.leaf_views(data), leaves, shard.specs):
        whole = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.asarray(leaf, np.float32))
        view.copy_(whole[block_slices(view.shape, spec, coords, sizes)])
    del params, leaves
    return GridParams(data, shard, pl), spmd


def _grid_init(cfg: Config, params, mesh: GridMesh, device) -> TrainState:
    flat, spmd = grid_params(cfg, params, mesh, device)
    opt = make_optimizer(cfg.optimizer, backend=cfg.parallel.backend,
                         effective_batch=cfg.global_batch, spmd=spmd)
    return TrainState(flat, opt.init(flat), 0)


def _live_tokens(batch) -> float:
    """Real (non-pad) token count of a batch: explicit mask > packed
    positions (pad rows carry position -1) > every element of the
    targets/tokens leaf > leading dim for non-token batches."""
    if isinstance(batch, dict):
        if "mask" in batch:
            return float((torch.as_tensor(batch["mask"]) > 0).sum())
        if "positions" in batch:
            return float((torch.as_tensor(batch["positions"]) >= 0).sum())
        for key in ("targets", "tokens"):
            if key in batch:
                return float(torch.as_tensor(batch[key]).numel())
    leaves = tree_leaves(batch)
    return float(leaves[0].shape[0]) if leaves else 1.0


def eval_loss(cfg: Config, loss_fn: Optional[Callable], params, batches: Iterable) -> float:
    """Mean loss over an eval stream, each batch's token-mean loss weighted
    by its REAL (non-pad) token count, so a padded final batch counts in
    proportion to the tokens it holds.

    ``params`` is a FlatParams (e.g. ``state.params``) or the port's params
    tree; ``loss_fn`` None builds ``make_loss_fn(cfg)``.  ``batches`` may be
    a data/memmap.py::IndexedPackedDataset: one finite pass over its epoch 0
    is evaluated (``epoch_batches``).  Batches go to the params' device."""
    if hasattr(batches, "epoch_batches"):
        batches = batches.epoch_batches()
    loss_fn = loss_fn or make_loss_fn(cfg)
    tree = params.tree if isinstance(params, FlatParams) else params
    device = tree_leaves(tree)[0].device
    total = weight = 0.0
    with torch.no_grad():
        for b in batches:
            w = _live_tokens(b)
            total += float(loss_fn(tree, _to_device(b, device))[0]) * w
            weight += w
    return total / max(weight, 1.0)


def train_loop(
    cfg: Config,
    batches: Iterable,
    steps: int,
    state: Optional[TrainState] = None,
    loss_fn: Optional[Callable] = None,
    log_every: int = 0,
    log_gsnr: bool = False,
    device=None,
    mesh=None,
):
    """The training loop: returns (state, history).

    With cfg.optimizer.gsnr_refresh = R > 1, vr_adam and vr_lamb take a
    fresh step (the k-group Σg² pass) every R-th step and stale steps (the
    b3-smoothed GSNR momentum of the last fresh step) between; every other
    optimizer steps fresh every time, as in the reference.  Under a mesh
    only rank 0 prints."""
    device = _device_of(device, mesh)
    step_fn, _ = make_train_step(cfg, loss_fn, log_gsnr=log_gsnr, device=device, mesh=mesh)
    supports_stale = cfg.optimizer.name in ("vr_adam", "vr_lamb")
    refresh = max(1, cfg.optimizer.gsnr_refresh) if supports_stale else 1
    state = state or init_state(cfg, device=device, mesh=mesh)
    history = []
    it = iter(batches)
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_fn(state, next(it), refresh == 1 or i % refresh == 0)
        if log_every and (i % log_every == 0 or i == steps - 1):
            m = {k_: float(v) for k_, v in metrics.items()}
            m["step"], m["wall"] = i, time.time() - t0
            history.append(m)
            if mesh is not None and mesh.rank != 0:
                continue
            print(
                f"  step {i:5d} loss {m['loss']:.4f} |g| {m['grad_norm']:.3f}"
                + (f" gsnr {m['gsnr/mean']:.3f}" if "gsnr/mean" in m else "")
                + (f" pack {m['pack_efficiency']:.2f}" if "pack_efficiency" in m else ""),
                flush=True,
            )
    return state, history
