"""What the VR optimizers need of the baseline optimizers.

Port of the parts of ``repro/core/baselines.py`` that VR-LAMB uses: the
optax-like ``Transform`` interface and LAMB's norm helpers.  The baseline
optimizers themselves (SGD, Momentum, Adam, LARS, LAMB) are not ported yet.

    Transform.init(params)                              -> state
    Transform.update(grads, state, params, stats=None)  -> (updates, state)

updates are deltas: theta <- theta + updates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _tensor_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.float())))


def _lamb_phi(x: torch.Tensor) -> torch.Tensor:
    """LAMB's phi: clip ||w|| to [0, 10]."""
    return torch.clamp(x, 0.0, 10.0)
