"""Train state container (port of ``repro/train/train_state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any  # core/layout.py::FlatParams (flat f32 buffer; leaves are views)
    opt_state: Any  # fused plan: m/v/p are FlatBuffers; reference plan: stacked trees
    step: int  # mirrors opt_state["step"]
    # Dynamic accumulation count (train/autoscale.py).  None on fixed-k runs,
    # where it adds no leaf to a checkpoint.  The train step passes it
    # through untouched; only the autoscale loop writes it.
    k: Any = None

    def with_unpacked_opt_state(self) -> "TrainState":
        """TrainState with any FlatBuffer optimizer state expanded to the
        stacked tree of the reference's format (views; a row-sharded buffer
        must be gathered first).  The checkpoint does this at the save
        boundary."""
        from repro_torch.core.layout import unpack_tree

        return self._replace(opt_state=unpack_tree(self.opt_state))
