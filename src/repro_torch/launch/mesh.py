"""The port's process mesh: one data axis over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py`` for data parallelism: where the
reference builds a ``jax.sharding.Mesh`` over devices, the port's mesh is
the process group of its ranks, one process per rank.  ``DataMesh`` names
the group, its size and this process's rank and device, and carries the
collectives the data-parallel steps use (sum all-reduce, sum
reduce-scatter, all-gather, broadcast).  Tensors stay on the rank's device
whichever transport the group uses: NCCL reduces CUDA tensors on the cards;
gloo takes CUDA tensors too (the installed PyTorch's gloo stages them
through host memory itself) and is what two ranks sharing one card, or
ranks on the CPU, must use.  The process-group backend is always an
explicit argument.

``GridMesh`` is the 2-D (data, model) mesh of the weights' FSDP+TP
sharding (sharding/rules.py, sharding/placement.py): D x M ranks of the
default group, rank ``i * M + j`` at data index i and model index j (the
reference's devices reshaped to (D, M)).  It builds one sub-group per data
row (its M model ranks) and one per model column (its D data ranks), and
its collectives take an axis name or a tuple of them: all-gather,
reduce-scatter, all-reduce (sum or max) and broadcast; ``gather`` brings
every rank's tensor to one rank.  ``axis(name)`` is
the DataMesh-like view of one axis (its size, this rank's index, its
all-reduce), through which the data-parallel code splits and averages over
the data axis.  NCCL with one card per rank or gloo (ranks sharing a card,
or the CPU) carry it, the backend always an explicit argument.

``run_ranks`` (``start_ranks`` then ``wait_ranks``) starts a function in W
fresh processes and waits for them under a deadline, so a rank that hangs
in a collective fails the run instead of blocking it.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DIST_BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis: the ``size`` ranks of the default process group; this
    process is ``rank``."""

    size: int
    rank: int
    device: torch.device
    backend: str

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t)
        return t

    def reduce_scatter_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks and return this rank's share of the sum,
        a new tensor: rows [rank * R, (rank + 1) * R) of its dim 0, where t
        holds size * R rows (a flat buffer zero-padded to whole shards).

        Both backends run one ``reduce_scatter_tensor``: NCCL on the cards;
        gloo on CPU tensors and on CUDA tensors (staged through host
        memory)."""
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter_: {t.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        out = torch.empty((t.shape[0] // self.size, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous())
        return out

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 into ``out`` (size *
        len(t) rows), rank order."""
        if out.shape[0] != self.size * t.shape[0] or out.shape[1:] != t.shape[1:]:
            raise ValueError(f"all_gather: out {tuple(out.shape)} does not hold {self.size} x "
                             f"{tuple(t.shape)}")
        dist.all_gather(list(out.chunk(self.size)), t)
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        """Wait until every rank has reached this call."""
        dist.barrier()

    def close(self) -> None:
        """Wait for every rank, then leave the process group (a rank that
        exits with the group alive can abort in its transport's threads)."""
        dist.barrier()
        dist.destroy_process_group()


def init_data_mesh(dist_backend: str, device=None, *, init_method: str = "env://",
                   world_size: Optional[int] = None, rank: Optional[int] = None) -> DataMesh:
    """Join (or reuse) the default process group over ``dist_backend``
    ("nccl" or "gloo") and return its DataMesh.  ``init_method`` "env://"
    reads torchrun's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE; otherwise
    give world_size and rank.  ``device`` None means the card: for NCCL
    cuda:LOCAL_RANK (one card per rank), for gloo cuda:0."""
    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"dist_backend={dist_backend!r}: must be one of {DIST_BACKENDS}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              if dist_backend == "nccl" else 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(device)
    elif dist_backend == "nccl":
        raise ValueError("the nccl backend reduces CUDA tensors only; use gloo on the CPU")
    if dist.is_initialized():
        if dist.get_backend() != dist_backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, not "
                             f"{dist_backend!r}")
    else:
        given = {k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None}
        dist.init_process_group(backend=dist_backend, init_method=init_method, **given)
    return DataMesh(dist.get_world_size(), dist.get_rank(), device, dist_backend)


Axes = Union[str, Sequence[str]]


class AxisMesh:
    """Axes of a GridMesh seen as a data mesh: the ``size`` ranks that share
    this rank's coordinates on the other axes, this rank's index ``rank``
    among them (group order), and collectives over them."""

    def __init__(self, grid: "GridMesh", axes: Axes):
        self.grid, self.axes = grid, grid._axes(axes)
        members = grid.members(self.axes)
        self.size, self.rank = len(members), members.index(grid.rank)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        return self.grid.all_reduce_(t, self.axes)

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` stacked along dim 0 into ``out``, group order."""
        return torch.cat(self.grid.all_gather(t, self.axes), out=out)


class GridMesh:
    """A (data, model) grid of ``data`` x ``model`` ranks of the default
    process group; this process is ``rank`` = i * model + j.  Build it with
    ``init_grid_mesh`` (every rank, the sub-groups are collective calls).
    With ``timed`` set, each collective synchronizes the card around it and
    adds its host wall to ``walls[(kind, bytes)]`` = [ms, calls]."""

    axis_names: Tuple[str, str] = ("data", "model")

    def __init__(self, data: int, model: int, rank: int, device: torch.device, backend: str):
        if data * model != dist.get_world_size():
            raise ValueError(f"a {data} x {model} grid needs {data * model} ranks; the process "
                             f"group has {dist.get_world_size()}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (data, model)))
        self.size, self.rank, self.device, self.backend = data * model, rank, device, backend
        self.coords: Dict[str, int] = dict(zip(self.axis_names, divmod(rank, model)))
        self.timed = False
        self.walls: Dict[Tuple[str, int], List[float]] = {}
        # every rank creates every sub-group, in one order
        rows = [dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
        cols = [dist.new_group([i * model + j for i in range(data)]) for j in range(model)]
        i, j = divmod(rank, model)
        dp, tp = self.axis_names
        self._groups = {(dp,): cols[j], (tp,): rows[i], (dp, tp): None}

    def coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names, divmod(rank, self.shape[self.axis_names[1]])))

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the grid's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def members(self, axes: Axes) -> List[int]:
        """The global ranks of this rank's group along ``axes`` (those that
        differ from it only there), in group order."""
        names = self._axes(axes)
        mine = self.coords
        return [r for r in range(self.size)
                if all(c == mine[a] for a, c in self.coords_of(r).items() if a not in names)]

    def axis(self, axes: Axes) -> AxisMesh:
        """The DataMesh-like view of ``axes`` (one name or several)."""
        return AxisMesh(self, axes)

    def _group(self, axes: Axes):
        return self._groups[self._axes(axes)]

    def _timed(self, kind: str, t: torch.Tensor, fn):
        if not self.timed:
            return fn()
        key = (kind, t.numel() * t.element_size())
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        w = self.walls.setdefault(key, [0.0, 0])
        w[0] += (time.perf_counter() - t0) * 1e3
        w[1] += 1
        return out

    def all_reduce_(self, t: torch.Tensor, axes: Optional[Axes] = None,
                    op: str = "sum") -> torch.Tensor:
        """``t`` summed (or its maximum, ``op="max"``) over ``axes`` (all of
        them by default), in place."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group = self._group(self.axis_names if axes is None else axes)
        self._timed(f"all_reduce {op}", t, lambda: dist.all_reduce(t, red, group=group))
        return t

    def all_gather(self, t: torch.Tensor, axes: Axes) -> List[torch.Tensor]:
        """Every ``members(axes)`` rank's ``t``, in group order (new tensors)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in self.members(axes)]
        group = self._group(axes)
        self._timed("all_gather", t, lambda: dist.all_gather(parts, t, group=group))
        return parts

    def gather(self, t: torch.Tensor, dst: int) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` on global rank ``dst``, in rank order (new
        tensors); None on the other ranks."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)] if self.rank == dst else None
        self._timed("gather", t, lambda: dist.gather(t, parts, dst=dst))
        return parts

    def reduce_scatter_(self, stacked: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``stacked`` holds one block per ``members(axes)`` rank along dim 0;
        returns the sum over the group of the block at this rank's slot (a
        new tensor of one block's shape)."""
        n = len(self.members(axes))
        if stacked.shape[0] != n:
            raise ValueError(f"reduce_scatter_: {stacked.shape[0]} blocks for {n} ranks")
        out = torch.empty(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
        group = self._group(axes)
        self._timed("reduce_scatter", stacked, lambda: dist.reduce_scatter_tensor(
            out[None], stacked.contiguous(), group=group))
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0,
                   axes: Optional[Axes] = None) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every rank of ``src``'s group along
        ``axes`` (all of them by default), in place."""
        group = self._group(self.axis_names if axes is None else axes)
        self._timed("broadcast", t, lambda: dist.broadcast(t, src, group=group))
        return t

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        """Wait for every rank, then leave the process group."""
        dist.barrier()
        dist.destroy_process_group()


def init_grid_mesh(dist_backend: str, data: int, model: int, device=None, *,
                   init_method: str = "env://", rank: Optional[int] = None) -> GridMesh:
    """Join (or reuse) the default process group of ``data * model`` ranks
    over ``dist_backend`` and return this rank's GridMesh (``device`` as
    for ``init_data_mesh``: None means the card)."""
    flat = init_data_mesh(dist_backend, device, init_method=init_method,
                          world_size=None if init_method == "env://" else data * model, rank=rank)
    return GridMesh(data, model, flat.rank, flat.device, dist_backend)


def make_host_mesh(data: int, rank: int, init_method: str) -> DataMesh:
    """A gloo mesh of ``data`` CPU ranks (tests; the reference's
    ``make_host_mesh`` fakes host devices instead)."""
    return init_data_mesh("gloo", "cpu", init_method=init_method, world_size=data, rank=rank)


def local_init_method() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a port that was free."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def start_ranks(fn: Callable, nprocs: int, args: tuple = ()):
    """Start ``fn(rank, *args)`` in ``nprocs`` spawned processes; returns
    the handle ``wait_ranks`` takes."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")


def wait_ranks(ctx, deadline_s: float) -> None:
    """Wait for the ranks of ``start_ranks``.  A rank that raises or dies
    fails the call (the others are stopped); when ``deadline_s`` passes
    first, every rank still running is killed and TimeoutError is raised."""
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks still running after {deadline_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def run_ranks(fn: Callable, nprocs: int, args: tuple = (), deadline_s: float = 600.0) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, waited for under
    a deadline (``wait_ranks``)."""
    wait_ranks(start_ranks(fn, nprocs, args), deadline_s)
