"""Config registry of the port: the architectures it runs.

``get_config(arch)`` / ``get_smoke(arch)`` resolve an architecture id
(dashes as published) to its full / reduced config.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (public re-exports)
    Config,
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelismConfig,
    smoke_variant,
)

ARCH_MODULES: Dict[str, str] = {
    "bert-large": "bert_large",
    "internlm2-1.8b": "internlm2_1_8b",
    "granite-3-2b": "granite_3_2b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-20b": "granite_20b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> Config:
    return _module(arch).config()


def get_smoke(arch: str) -> Config:
    return _module(arch).smoke()
