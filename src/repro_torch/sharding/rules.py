"""Divisibility-adaptive sharding rules.

Port of ``repro/sharding/rules.py``.  Parameters get FSDP+TP by default:
for every weight leaf the last dim maps to the tensor-parallel axis
("model") and the second-to-last to the FSDP axis ("data"), *only when the
dimension divides the axis size* -- so whisper's 12 heads simply stay
replicated on a 16-way model axis instead of erroring.  Expert leaves
("expert_*") prefer expert parallelism (expert dim over "model"); when the
expert count does not divide (mixtral: 8 experts, 16-way axis) they fall
back to tensor parallelism inside each expert.  The token embedding shards
its vocab over "model" (a masked lookup plus an all-reduce), and 1-D leaves
stay replicated.

Logical activation axes resolve against the mesh:

  batch      -> ("pod", "data") (whichever exist & divide)
  cache_seq  -> "data"  (sequence-parallel KV caches for tiny-batch decode)
  experts    -> "model" when divisible
  expert_cap -> "data"
  ff / heads -> "model"

The rules work on a mesh *shape*: anything with ``axis_names`` and a
``shape`` mapping of name -> size (``MeshShape``, or a launch/mesh.py::
GridMesh), as the reference's ``AbstractMesh``, so no rank is needed to
compute a spec.  A ``Spec`` is the port's partition spec: an immutable
tuple with one entry per dimension, each None, an axis name or a tuple of
names.  sharding/placement.py carries the weights out by these specs on a
GridMesh of ranks.

``flat_buffer_shard`` is the flat-buffer row rule of the data mesh
(launch/mesh.py::DataMesh): a packed ``(n_rows, 128)`` buffer shards its
rows over the ranks (core/layout.py::RowShard), with zero blocks of leaf id
0 appended when the block count does not divide (``FlatSpmd._pad_rows`` /
``_meta`` in the reference's backend.py); a mesh of one rank keeps the
buffer whole.

``activate(mesh)`` installs rules process-wide (a context manager); without
active rules every constraint is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.layout import FlatBuffer, ParamLayout, RowShard, is_flat

_ACTIVE: Optional["Rules"] = None


class Spec(tuple):
    """A partition spec: one entry per dimension, each None (replicated), an
    axis name or a tuple of axis names (the dim split over their product,
    the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)

    def axes(self) -> Tuple[str, ...]:
        """Every axis name the spec uses, in dim order."""
        return tuple(a for e in self for a in entry_axes(e))


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes without ranks (the reference's AbstractMesh)."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: object
    fsdp: bool = True
    tp_axis: str = "model"
    dp_axis: str = "data"
    pod_axis: str = "pod"
    shard_cache_seq: bool = True
    cache_seq_tp: bool = True  # decode caches: seq dim over leftover axes
    fsdp_over_pod: bool = False  # FSDP over ("pod", "data") on multi-pod meshes

    # -- helpers ------------------------------------------------------------
    def axis_size(self, name: str) -> int:
        return dict(self.mesh.shape).get(name, 0)

    def has_axis(self, name: str) -> bool:
        return name in self.mesh.axis_names

    def fsdp_axes(self):
        if self.fsdp_over_pod and self.has_axis(self.pod_axis):
            return (self.pod_axis, self.dp_axis)
        return self.dp_axis

    def fits(self, dim: int, axis) -> bool:
        if axis is None:
            return False
        total = 1
        for a in entry_axes(axis):
            if not self.has_axis(a):
                return False
            total *= self.axis_size(a)
        return dim % total == 0 and dim >= total

    def batch_axes(self, batch: int):
        """Best mesh axes for the batch dim: ("pod","data"), "data", "pod", None."""
        cands = []
        if self.has_axis(self.pod_axis):
            cands.append((self.pod_axis, self.dp_axis))
            cands.append((self.pod_axis,))
        cands.append((self.dp_axis,))
        for c in cands:
            cc = tuple(a for a in c if self.has_axis(a))
            if cc and self.fits(batch, cc):
                return cc if len(cc) > 1 else cc[0]
        return None

    def resolve(self, logical: Optional[str], dim: int):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes(dim)
        table = {
            "tp": self.tp_axis,
            "ff": self.tp_axis,
            "heads": self.tp_axis,
            "vocab": self.tp_axis,
            "experts": self.tp_axis,
            "fsdp": self.dp_axis if self.fsdp else None,
            "expert_cap": self.dp_axis,
            "cache_seq": self.dp_axis if self.shard_cache_seq else None,
        }
        axis = table.get(logical)
        return axis if self.fits(dim, axis) else None

    # -- parameter specs ----------------------------------------------------
    def leaf_pspec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2:
            used = set()
            if path.endswith("embed") and nd == 2:
                # token-embedding table: vocab over "model" (the lookup is a
                # masked gather plus an all-reduce), features over FSDP
                if self.fits(shape[0], self.tp_axis):
                    spec[0] = self.tp_axis
                if self.fsdp and self.fits(shape[1], self.fsdp_axes()):
                    spec[1] = self.fsdp_axes()
            elif "expert_" in path and nd >= 3:
                # (..., E, d_in, d_out): expert-parallel preferred
                e_dim = nd - 3
                if self.fits(shape[e_dim], self.tp_axis):
                    spec[e_dim] = self.tp_axis
                    used.add(self.tp_axis)
                if self.fsdp and self.fits(shape[nd - 2], self.fsdp_axes()):
                    spec[nd - 2] = self.fsdp_axes()
                    used.add(self.dp_axis)
                if self.tp_axis not in used and self.fits(shape[nd - 1], self.tp_axis):
                    spec[nd - 1] = self.tp_axis
            else:
                if self.fits(shape[nd - 1], self.tp_axis):
                    spec[nd - 1] = self.tp_axis
                if self.fsdp and self.fits(shape[nd - 2], self.fsdp_axes()):
                    spec[nd - 2] = self.fsdp_axes()
        # a 1-D leaf stays replicated, whatever its size: cheap and robust
        return Spec(*spec)

    def flat_buffer_pspec(self, shape: Tuple[int, ...]) -> Spec:
        """FSDP rule for a packed (n_rows, 128) FlatBuffer: the ROWS over the
        FSDP axes, the 128-lane dim whole (the generic 2-D weight rule would
        TP-shard the lanes)."""
        axes = self.fsdp_axes() if self.fsdp else None
        return Spec(axes if (axes is not None and self.fits(shape[0], axes)) else None, None)

    def flat_buffer_shard(self, layout: ParamLayout) -> Optional[RowShard]:
        """This rank's RowShard of ``layout``'s flat buffer on a data mesh,
        or None when the mesh has one rank."""
        if self.mesh.size == 1:
            return None
        return RowShard(layout, self.mesh.size, self.mesh.rank)


def param_specs(params, rules: Optional[Rules] = None):
    """The spec of every leaf of ``params`` (a tree with the reference's
    tree paths: dicts in sorted key order, list entries by index); a
    FlatBuffer keeps its node, its spec inside (``flat_buffer_pspec``)."""
    r = rules or _ACTIVE
    if r is None:
        raise RuntimeError("no active sharding rules; call sharding.activate(mesh)")

    def walk(x, prefix: str):
        if is_flat(x):
            return FlatBuffer(r.flat_buffer_pspec(x.shape), x.layout)
        if isinstance(x, dict):
            return {k: walk(x[k], f"{prefix}{k}/") for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(x)]
        return r.leaf_pspec(prefix[:-1], tuple(x.shape))

    return walk(params, "")


def batch_spec(shape: Tuple[int, ...], rules: Rules, batch: int, kind: str = "batch") -> Spec:
    """The spec of a host-batch or decode-cache leaf of ``shape`` (the
    reference's ``launch/specs.py::batch_pspec``).  The batch dim is found
    by size (dim 0, or 1 for a cache stacked over layer groups);
    ``kind="cache"`` also places the sequence dim after it: over every
    mesh axis the batch left unused (``cache_seq_tp``), or, when the batch
    cannot shard, over "data" (``shard_cache_seq``)."""
    dims = tuple(shape)
    axes = [None] * len(dims)
    cand = [i for i in range(min(2, len(dims))) if dims[i] == batch]
    if not cand:
        return Spec(*axes)
    bidx = cand[-1]  # stacked scan caches carry (groups, B, ...)
    b_axes = rules.batch_axes(batch)
    if b_axes is not None:
        axes[bidx] = b_axes
    sdim = bidx + 1
    if kind == "cache" and sdim < len(dims):
        used = set(entry_axes(b_axes))
        free = [a for a in (rules.pod_axis, rules.dp_axis, rules.tp_axis)
                if rules.has_axis(a) and a not in used]
        cands = []
        if rules.cache_seq_tp:
            if len(free) > 1:
                cands.append(tuple(free))
            cands += [(a,) for a in free]
        elif b_axes is None and rules.shard_cache_seq and rules.dp_axis in free:
            cands = [(rules.dp_axis,)]
        for c in cands:
            if c and rules.fits(dims[sdim], c):
                axes[sdim] = c if len(c) > 1 else c[0]
                break
    return Spec(*axes)


def batch_axes(batch: int):
    return _ACTIVE.batch_axes(batch) if _ACTIVE else None


def pspec_for_leaf(path: str, shape) -> Spec:
    return _ACTIVE.leaf_pspec(path, tuple(shape)) if _ACTIVE else Spec()


def _check_rank(x, n: int, what: str) -> None:
    if x.ndim != n:
        raise ValueError(f"{what}: {n} logical axes for a tensor of rank {x.ndim}")


def constrain_like_param(x, path: str):
    """The activation or weight view ``x`` held to the PARAM rule for
    ``path``.  The port's tensors are each rank's own blocks, so nothing
    moves: without active rules this is the identity; with them the rule is
    resolved, which checks that the path's rule applies to a tensor of
    ``x``'s rank."""
    if _ACTIVE is None:
        return x
    _check_rank(x, len(_ACTIVE.leaf_pspec(path, tuple(x.shape))), f"constrain_like_param {path}")
    return x


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    """``x`` held to the logical axes against the active rules; the identity
    without them.  Under a grid the port's activations are local tensors
    (each rank's rows of the batch), so nothing moves: the axes are
    resolved against ``x``'s dims, which must match them in number."""
    if _ACTIVE is None:
        return x
    _check_rank(x, len(logical_axes), "constrain")
    for a, d in zip(logical_axes, x.shape):
        _ACTIVE.resolve(a, d)
    return x


def active_rules() -> Optional[Rules]:
    return _ACTIVE


@contextlib.contextmanager
def activate(mesh, **kw):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Rules(mesh=mesh, **kw)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev
