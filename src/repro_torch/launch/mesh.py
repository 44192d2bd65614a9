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

``run_ranks`` (``start_ranks`` then ``wait_ranks``) starts a function in W
fresh processes and waits for them under a deadline, so a rank that hangs
in a collective fails the run instead of blocking it.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Callable, Optional

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
