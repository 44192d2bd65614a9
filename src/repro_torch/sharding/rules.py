"""Sharding rules of the port: the flat-buffer row rule.

Port of ``repro/sharding/rules.py::Rules.flat_buffer_pspec``: a packed
``(n_rows, 128)`` flat buffer shards its ROWS over the data axis (FSDP of
the optimizer state) and keeps the 128 lanes whole.  On a mesh of W ranks,
rank r holds the r-th of W contiguous equal block ranges
(core/layout.py::RowShard), with zero blocks of leaf id 0 appended when the
block count does not divide (``FlatSpmd._pad_rows`` / ``_meta`` in the
reference's backend.py), so any rank count shards the rows.  A mesh of one
rank keeps the buffer whole (no shard).

Not yet ported: TP and FSDP of the model's weights (the reference's
per-leaf rules, its activation constraints and its expert rules).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.layout import ParamLayout, RowShard


@dataclasses.dataclass(frozen=True)
class Rules:
    """The flat-buffer rule over a ``launch/mesh.py::DataMesh``."""

    mesh: object

    def flat_buffer_shard(self, layout: ParamLayout) -> Optional[RowShard]:
        """This rank's RowShard of ``layout``'s flat buffer, or None when the
        mesh has one rank."""
        if self.mesh.size == 1:
            return None
        return RowShard(layout, self.mesh.size, self.mesh.rank)
