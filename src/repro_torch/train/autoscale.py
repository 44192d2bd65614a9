"""Online batch-size autoscaling driven by the measured gradient noise scale.

Port of ``repro/train/autoscale.py``.  Each optimizer step consumes k
microbatches (effective batch = k x microbatch rows), reads the critical
batch size B_simple ~ tr(Sigma)/|G|^2 off the step's own moment carry
(core/noise_scale.py: no extra kernel launch), EMA-smooths it, and lets an
:class:`AutoscalePolicy` move k toward the measured limit — warmup-frozen,
hysteresis-banded, cooldown-limited, clamped, at most doubling/halving per
change.  When k changes the loop takes the step made for that k (built once
per k and kept: the reference jits one per k, the port builds the eager
step) and the LR rescales through core/schedule.py's sqrt/linear rule with
the LIVE effective batch (OptimizerConfig.base_batch / lr_scale_rule).

The optimizer state flows across k changes unchanged: its structure depends
only on the ParamLayout, never on k, and the moment carry is allocated per
step, so a kept step holds no per-k device buffer.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Config
from repro_torch.core import noise_scale as ns
from repro_torch.core.layout import tree_leaves
from repro_torch.train.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Maps the smoothed B_simple to the next accumulation count k.

    k_min/k_max:     hard clamp (k_min >= 2 — the estimator needs two group
                     sizes, so B_small = B/k must differ from B_big = B)
    warmup_steps:    freeze k while the EMA warms up
    cooldown:        minimum steps between consecutive k changes
    hysteresis:      move only when the target leaves (k/h, k·h) — bounces
                     inside the band are noise, not signal
    target_frac:     aim the effective batch at target_frac × B_simple
    max_step_factor: at most ×/÷ this per change (gradual ramp; the sqrt LR
                     rule then moves the LR by √factor per change)
    ema_beta:        EMA decay for the tr(Σ)/|G|² smoothing
    """

    k_min: int = 2
    k_max: int = 64
    warmup_steps: int = 10
    cooldown: int = 5
    hysteresis: float = 1.5
    target_frac: float = 1.0
    max_step_factor: int = 2
    ema_beta: float = 0.9

    def __post_init__(self):
        if self.k_min < 2:
            raise ValueError(f"k_min={self.k_min}: the estimator needs k >= 2")
        if self.k_max < self.k_min:
            raise ValueError(f"k_max={self.k_max} < k_min={self.k_min}")
        if self.hysteresis <= 1.0:
            raise ValueError(f"hysteresis={self.hysteresis} must be > 1")
        if self.max_step_factor < 2:
            raise ValueError(f"max_step_factor={self.max_step_factor} must be >= 2")
        if not 0.0 <= self.ema_beta < 1.0:
            raise ValueError(f"ema_beta={self.ema_beta} must be in [0, 1)")

    def feasible_ks(self, batch_size: int) -> Tuple[int, ...]:
        """Divisors of ``batch_size`` within [k_min, k_max] — the only k
        values core/accumulate.split_batch accepts when the loader batch is
        fixed (its ValueError points here)."""
        if batch_size <= 0:
            raise ValueError(f"batch_size={batch_size} must be positive")
        return tuple(
            k
            for k in range(self.k_min, min(self.k_max, batch_size) + 1)
            if batch_size % k == 0
        )

    def propose(
        self,
        *,
        step: int,
        current_k: int,
        b_simple: float,
        microbatch_size: int,
        last_change_step: Optional[int] = None,
        feasible: Optional[Tuple[int, ...]] = None,
    ) -> int:
        """The next k (== current_k when frozen, banded, cooling, or b_simple
        is unusable).  ``feasible``, when given, snaps the proposal to the
        nearest allowed value in log space (use feasible_ks(batch) when the
        loader batch is fixed and k must divide it)."""
        if step < self.warmup_steps:
            return current_k
        if last_change_step is not None and step - last_change_step < self.cooldown:
            return current_k
        b = float(b_simple)
        if not math.isfinite(b) or b <= 0:
            return current_k
        k_target = self.target_frac * b / float(microbatch_size)
        if current_k / self.hysteresis < k_target < current_k * self.hysteresis:
            return current_k
        if k_target > current_k:
            k_new = min(current_k * self.max_step_factor, int(k_target))
        else:
            k_new = max(current_k // self.max_step_factor, int(math.ceil(k_target)))
        k_new = max(self.k_min, min(self.k_max, k_new))
        if feasible:
            k_new = min(feasible, key=lambda f: abs(math.log(f / k_new)))
        return k_new


def autoscale_train_loop(
    cfg: Config,
    microbatches: Iterable,
    steps: Optional[int] = None,
    *,
    policy: Optional[AutoscalePolicy] = None,
    state: Optional[TrainState] = None,
    loss_fn: Optional[Callable] = None,
    token_budget: Optional[int] = None,
    log_every: int = 0,
    device=None,
) -> Tuple[TrainState, list]:
    """Autoscaled driver.  Returns (state, history).

    ``microbatches`` is either

      - an iterator of FIXED-size microbatches (dicts of arrays or tensors):
        each optimizer step concatenates k of them (effective batch = k x
        microbatch rows); or
      - a data/memmap.py::IndexedPackedDataset: the loop then drives the
        LOADER batch — each step requests exactly k x batch_rows packed
        rows from the epoch's pack index, and history rows also carry the
        data epoch and the epoch's pack_efficiency.

    Stops after ``steps`` optimizer steps or once ``token_budget`` token
    SLOTS are consumed (whichever comes first; at least one must be given).
    ``state`` None starts from ``init_state`` at the first k; the steps run
    on ``device`` (None: the card; the params' device when ``state`` is
    given).

    Every history row records step, k, effective_batch, loss, lr, b_simple,
    b_simple_ema, tokens and wall (seconds since the loop started, read
    after the step's loss reached the host)."""
    if steps is None and token_budget is None:
        raise ValueError("autoscale_train_loop: give steps=, token_budget=, or both")
    from repro_torch.train.loss import make_loss_fn
    from repro_torch.train.trainer import init_state, make_train_step

    policy = policy or AutoscalePolicy()
    opt_cfg = cfg.optimizer
    loss_fn = loss_fn or make_loss_fn(cfg)

    indexed = hasattr(microbatches, "next_batch") and hasattr(microbatches, "batch_rows")
    if indexed:
        ds = microbatches
        mb_rows = int(ds.batch_rows)
        mb_tokens = mb_rows * int(ds.seq_len)
        it, pending = None, []
    else:
        it = iter(microbatches)
        first = next(it)
        mb_rows = int(tree_leaves(first)[0].shape[0])
        mb_tokens = (int(np.prod(first["tokens"].shape))
                     if isinstance(first, dict) and "tokens" in first else mb_rows)
        pending = [first]

    def cfg_for(k: int) -> Config:
        return cfg.replace(global_batch=k * mb_rows, optimizer=dataclasses.replace(opt_cfg, k=k))

    if state is not None:
        device = state.params.device
    cache = {}

    def step_fn_for(k: int):
        if k not in cache:
            cache[k] = make_train_step(cfg_for(k), loss_fn, noise_scale=True, device=device)[0]
        return cache[k]

    k = max(policy.k_min, min(policy.k_max, opt_cfg.k))
    if state is None:
        state = init_state(cfg_for(k), device=device)
    state = state._replace(k=k)

    noise_st = ns.init_noise_state()
    consumed = 0
    last_change: Optional[int] = None
    history = []
    i = 0
    t0 = time.time()
    while True:
        if steps is not None and i >= steps:
            break
        if token_budget is not None and consumed >= token_budget:
            break
        if indexed:
            batch = ds.next_batch(k * mb_rows)
        else:
            while len(pending) < k:
                pending.append(next(it))
            mbs, pending = pending[:k], pending[k:]
            batch = {name: _concat([mb[name] for mb in mbs]) for name in mbs[0]}
        state, metrics = step_fn_for(k)(state, batch)
        consumed += k * mb_tokens
        noise_st, smoothed = ns.update_noise_state(
            noise_st, float(metrics["noise/tr_sigma"]), float(metrics["noise/g2"]),
            beta=policy.ema_beta)
        row = {
            "step": i,
            "k": k,
            "effective_batch": k * mb_rows,
            "loss": float(metrics["loss"]),
            "lr": float(metrics.get("lr", 0.0)),
            "b_simple": float(metrics["noise/b_simple"]),
            "b_simple_ema": smoothed.b_simple,
            "tokens": consumed,
            "wall": time.time() - t0,
        }
        if indexed:
            row["epoch"] = int(ds.state.epoch)
            pe = ds.last_pack_efficiency
            if pe is not None:
                row["pack_efficiency"] = float(pe)
        history.append(row)
        if log_every and (i % log_every == 0):
            print(f"  step {i:5d} k {k:3d} eff {k * mb_rows:5d} "
                  f"loss {row['loss']:.4f} B_simple {smoothed.b_simple:.1f}", flush=True)
        proposal = policy.propose(step=i, current_k=k, b_simple=smoothed.b_simple,
                                  microbatch_size=mb_rows, last_change_step=last_change)
        if proposal != k:
            last_change, k = i, proposal
            state = state._replace(k=k)
        i += 1
    return state, history


def _concat(parts):
    """Microbatch leaves (numpy arrays or tensors) joined along rows."""
    if torch.is_tensor(parts[0]):
        return torch.cat(parts, 0)
    return np.concatenate([np.asarray(p) for p in parts], 0)
