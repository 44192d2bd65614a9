"""LR schedules used by the paper: linear warm-up + {cosine, polynomial,
linear, constant} decay, plus the square-root batch-size scaling rule the
paper adopts (sec. 6).  Port of ``repro/core/schedule.py``; the LR is a host
float, computed in float32 as the reference computes it."""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import OptimizerConfig


def sqrt_scaled_lr(base_lr: float, batch_size: int, base_batch: int) -> float:
    """Square-root scaling rule (paper sec. 6 / Table 12 LR columns)."""
    return base_lr * math.sqrt(batch_size / base_batch)


def linear_scaled_lr(base_lr: float, batch_size: int, base_batch: int) -> float:
    return base_lr * batch_size / base_batch


def scaled_lr(base_lr: float, batch_size: int, base_batch: int, rule: str = "sqrt") -> float:
    """Apply the named batch-size scaling rule ("sqrt" | "linear" | "none")."""
    if rule in ("none", ""):
        return base_lr
    if rule == "sqrt":
        return sqrt_scaled_lr(base_lr, batch_size, base_batch)
    if rule == "linear":
        return linear_scaled_lr(base_lr, batch_size, base_batch)
    raise ValueError(f"unknown lr_scale_rule {rule!r} (want sqrt|linear|none)")


def make_schedule(cfg: OptimizerConfig, effective_batch: Optional[int] = None) -> Callable:
    """Step -> LR.  cfg.lr is the PEAK at cfg.base_batch; with a live
    ``effective_batch`` (and cfg.base_batch > 0) the peak rescales through
    cfg.lr_scale_rule."""
    peak, warm, total = cfg.lr, max(cfg.warmup_steps, 1), max(cfg.total_steps, 2)
    if effective_batch and cfg.base_batch:
        peak = scaled_lr(cfg.lr, effective_batch, cfg.base_batch, cfg.lr_scale_rule)
    if cfg.schedule not in ("cosine", "poly", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    f32 = np.float32
    peak32 = f32(peak)

    def fn(step) -> float:
        step = f32(step)
        if step < warm:
            return float(peak32 * (step + f32(1)) / f32(warm))
        t = np.clip((step - f32(warm)) / f32(max(total - warm, 1)), f32(0), f32(1))
        if cfg.schedule == "cosine":
            decay = peak32 * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t))
        elif cfg.schedule == "poly":
            decay = peak32 * np.power(f32(1) - t, f32(2))
        elif cfg.schedule == "linear":
            decay = peak32 * (f32(1) - t)
        else:  # constant
            decay = peak32
        return float(decay)

    return fn
