"""Train state container (port of ``repro/train/train_state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any  # core/layout.py::FlatParams (flat f32 buffer; leaves are views)
    opt_state: Any  # fused plan: m/v/p are FlatBuffers; reference plan: stacked trees
    step: int  # mirrors opt_state["step"]
