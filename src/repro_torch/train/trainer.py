"""Training loop: the train step with k-group GSNR statistics.

Port of ``repro/train/trainer.py::make_train_step`` (the microbatch GSNR
source without a mesh, the data-axis source on a data mesh),
``init_state`` and ``train_loop``.  One fresh VR step is the paper's
Algorithm 1/3/5 end to end:

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
plain PyTorch versions.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.

Data parallelism (``mesh=``, a launch/mesh.py::DataMesh, with
``gsnr_source="data_axis"``; the reference's ``use_device_stats`` with its
``_shard_plan``): every rank holds the same params and takes one backward
over its rows of the global batch; one all-reduce of the [g; g^2] payload
(K11 on the fused plan) gives every rank the statistics of k = W groups
(core/distributed.py).  On the fused plan the VR update then runs per row
shard (``Backend.shard``: K13, an all-reduce, K14-K17, the optimizer state
holding the rank's rows) and the ranks' update rows are gathered and added
to every rank's params, so the params stay identical; update_norm comes
from the shards' sums of squares and one scalar all-reduce.  The reference
plan all-reduces the per-leaf stack and runs the tree math on every rank.
Not yet ported: the microbatch source, stale steps, the vmap stats method
and the baselines under a mesh, TP/FSDP sharding of the model's weights, and the noise-scale
readings.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.configs.base import Config
from repro_torch.core.accumulate import grad_only, grad_stats
from repro_torch.core.distributed import device_grad_stats_fn
from repro_torch.core.gsnr import gsnr_scale, gsnr_summary
from repro_torch.core.layout import FlatBuffer, FlatParams, tree_leaves, tree_map
from repro_torch.core.vrgd import make_optimizer
from repro_torch.models import init_params
from repro_torch.serve.engine import resolve_device
from repro_torch.train.loss import make_loss_fn
from repro_torch.train.train_state import TrainState


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (the zero tail of
    a flat buffer adds nothing)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


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


def make_train_step(
    cfg: Config,
    loss_fn: Optional[Callable] = None,
    log_gsnr: bool = False,
    device=None,
    mesh=None,
) -> Tuple[Callable, object]:
    """Returns (train_step(state, batch, with_stats=True) -> (state, metrics),
    optimizer).

    ``batch`` is a dict of (B, ...) arrays or tensors (moved to the device;
    under a mesh, the global batch, of which each rank takes its rows);
    ``with_stats=False`` makes a VR step stale.  Metrics are 0-dim tensors:
    loss, grad_norm, update_norm, the loss's own (ce, pack_efficiency) and,
    with ``log_gsnr`` on a fresh VR step, gsnr/mean, gsnr/min and
    gsnr/frac_floor; under a mesh they are the same on every rank."""
    opt_cfg = cfg.optimizer
    if mesh is None and opt_cfg.gsnr_source != "microbatch":
        raise NotImplementedError(
            f"gsnr_source={opt_cfg.gsnr_source!r} without a mesh is not ported (the reference "
            "then falls back to the microbatch source): pass mesh=")
    if mesh is not None and not (opt_cfg.is_vr and opt_cfg.gsnr_source == "data_axis"):
        raise NotImplementedError(
            f"{opt_cfg.name} with gsnr_source={opt_cfg.gsnr_source!r} under a mesh is not yet "
            "ported: a mesh runs the VR optimizers with gsnr_source='data_axis'")
    if mesh is not None and opt_cfg.stats_method == "vmap":
        raise NotImplementedError(
            "stats_method='vmap' under a mesh is not ported: the reference's vmap path has no "
            "per-shard form; use stats_method='scan'")
    device = _device_of(device, mesh)
    bk = cfg.parallel.backend
    if bk.resolve("stats", device) != bk.resolve("optimizer", device):
        raise NotImplementedError(
            "a plan whose stats and optimizer subsystems resolve to different modes "
            f"({bk.resolve('stats', device)} / {bk.resolve('optimizer', device)}) is not yet "
            "ported: the flat carry feeds only the flat update")
    opt = make_optimizer(opt_cfg, backend=bk, effective_batch=cfg.global_batch,
                         spmd=_shard_plan(bk, mesh))
    loss_fn = loss_fn or make_loss_fn(cfg)
    is_vr = opt_cfg.is_vr
    if mesh is not None:
        device_stats = device_grad_stats_fn(loss_fn, mesh, backend=bk)
    # the VR optimizers take and return FlatBuffers on the fused plan; the
    # baselines are tree math on either plan (core/baselines.py)
    flat_form = is_vr and bk.fused("optimizer", device)

    def train_step(state: TrainState, batch, with_stats: bool = True
                   ) -> Tuple[TrainState, Dict]:
        flat: FlatParams = state.params
        batch = _to_device(batch, flat.device)
        if mesh is not None:
            if not with_stats:
                raise NotImplementedError("a stale-GSNR step under a mesh is not yet ported")
            loss, aux, stats = device_stats(flat, batch)
            grads = stats.mean
        elif is_vr:
            loss, aux, stats = grad_stats(loss_fn, flat, batch, opt_cfg.k,
                                          method=opt_cfg.stats_method, squares=with_stats,
                                          backend=bk)
            grads = stats.mean
            if not with_stats:
                stats = None
        else:
            loss, aux, grads = grad_only(loss_fn, flat, batch)
            stats = None
        gnorm = global_norm(grads)
        if opt_cfg.grad_clip > 0:
            scale = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        w = FlatBuffer(flat.data, flat.layout) if flat_form else flat.stacked()
        with torch.no_grad():
            upd, opt_state = opt.update(grads, state.opt_state, w, stats=stats)
            shard = getattr(upd, "shard", None)
            if shard is None:
                tree_map(lambda p, u: p.add_(u), w, upd)
                unorm = global_norm(upd)
            else:  # the rank's rows: one scalar all-reduce, then every rank's rows
                unorm = torch.sqrt(mesh.all_reduce_(torch.sum(torch.square(upd.data))[None]))[0]
                flat.data.add_(shard.gather(upd.data, mesh))
        metrics = {"loss": loss, "grad_norm": gnorm, "update_norm": unorm, **aux}
        if log_gsnr and stats is not None:
            with torch.no_grad():
                metrics.update(gsnr_summary(gsnr_scale(stats, opt_cfg.gamma), opt_cfg.gamma))
        return state._replace(opt_state=opt_state, step=opt_state["step"]), metrics

    return train_step, opt


def init_state(cfg: Config, params: Optional[Dict] = None, device=None,
               mesh=None) -> TrainState:
    """TrainState with the params (the port's tree; default: seeded random
    init from ``cfg.seed``) copied into a FlatParams on ``device``, and the
    optimizer state of the plan ``cfg.parallel.backend`` resolves to.  Under
    a mesh every rank takes rank 0's params (a broadcast), and a sharded
    flat state holds the rank's rows."""
    device = _device_of(device, mesh)
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
