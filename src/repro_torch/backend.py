"""Execution plan of the port: which implementation serves each subsystem.

The counterpart of ``repro/backend.py::Backend``:

  =============  ===================================  =======================
  subsystem      fused                                reference
  =============  ===================================  =======================
  ``attention``  hand-written CUDA kernels            plain PyTorch SDPA /
                 (kernels/flash_attention.py,         chunked softmax
                 kernels/flash_attention_bwd.py,      (models/attention.py)
                 kernels/flash_decode.py)
  ``optimizer``  flat m/v/p state, one VR-LAMB        per-leaf tree math
                 kernel pass (kernels/flat_update.py)  (core/vrgd.py)
  ``stats``      flat (g_sum, g2_sum) carry, one      per-leaf tree carry
                 kernel per microbatch + finalize     (core/accumulate.py)
                 (kernels/flat_stats.py)
  =============  ===================================  =======================

Each mode is one of ``"fused" | "reference" | "auto"``.  ``"auto"`` resolves
per tensor: fused for every CUDA tensor, reference for a CPU tensor — so the
CPU tests run the plain paths without a flag, and on a card the kernels run
or their wrappers raise (a card other than Hopper, capability (9, 0), is
refused there; it never gets the plain version).  A fused plan on a CPU
tensor runs the kernel wrappers, which on the CPU compute their plain
version.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

FUSED = "fused"
REFERENCE = "reference"
AUTO = "auto"
_MODES = (FUSED, REFERENCE, AUTO)
SUBSYSTEMS = ("attention", "optimizer", "stats")
HOPPER = (9, 0)


@functools.lru_cache(maxsize=None)
def device_info(index: int):
    """((major, minor) capability, SM count) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return (props.major, props.minor), props.multi_processor_count


@dataclasses.dataclass(frozen=True)
class Backend:
    """Per-subsystem execution plan (frozen, hashable)."""

    attention: str = AUTO
    optimizer: str = AUTO
    stats: str = AUTO

    def __post_init__(self):
        for sub in SUBSYSTEMS:
            mode = getattr(self, sub)
            if mode not in _MODES:
                raise ValueError(f"Backend.{sub}={mode!r}: must be one of {_MODES}")

    def resolve(self, subsystem: str, device) -> str:
        """The concrete mode ("fused" | "reference") serving ``subsystem``
        for tensors on ``device``."""
        if subsystem not in SUBSYSTEMS:
            raise KeyError(f"unknown subsystem {subsystem!r}; one of {SUBSYSTEMS}")
        mode = getattr(self, subsystem)
        if mode == AUTO:
            return FUSED if torch.device(device).type == "cuda" else REFERENCE
        return mode

    def fused(self, subsystem: str, device) -> bool:
        return self.resolve(subsystem, device) == FUSED

    @classmethod
    def all_fused(cls) -> "Backend":
        return cls(attention=FUSED, optimizer=FUSED, stats=FUSED)

    @classmethod
    def all_reference(cls) -> "Backend":
        return cls(attention=REFERENCE, optimizer=REFERENCE, stats=REFERENCE)
