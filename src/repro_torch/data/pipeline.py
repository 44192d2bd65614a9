"""Batch placement for data parallelism.

Port of ``repro/data/pipeline.py::shard_batch`` / ``host_slice``: the global
batch splits into W contiguous row blocks, one per rank, as ``P(data)``
shards it in the reference.  Rank r's rows ``[r B/W, (r+1) B/W)`` are
microbatch r of ``core/accumulate.py::split_batch(batch, W)``, which is why
a W-rank data-parallel step sees the same groups as a k=W microbatch step.
"""
from __future__ import annotations

from typing import Dict


def shard_batch(batch: Dict, mesh) -> Dict:
    """This rank's rows of every (B, ...) leaf of ``batch``; raises when B
    does not divide over the mesh's ranks."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"shard_batch: leaf {name!r} has batch {b}, not divisible over "
                             f"{mesh.size} ranks (remainder {b % mesh.size})")
        per = b // mesh.size
        out[name] = x[mesh.rank * per: (mesh.rank + 1) * per]
    return out
