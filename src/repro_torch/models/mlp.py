"""Feed-forward blocks: SwiGLU (llama-style) and GELU (bert/whisper-style).
Port of ``repro/models/mlp.py``."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init


def mlp_init(gen, d_model: int, d_ff: int, act: str, device="cpu") -> Dict:
    p = {
        "wi": normal_init(gen, (d_model, d_ff), device=device),
        "wd": normal_init(gen, (d_ff, d_model), fan_in=d_ff, device=device),
    }
    if act == "swiglu":
        p["wg"] = normal_init(gen, (d_model, d_ff), device=device)
    return p


def mlp_hidden(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The block's hidden activation, the input of its ``wd`` projection."""
    dtype = x.dtype
    h = x @ p["wi"].to(dtype)
    if act == "swiglu":
        return F.silu(x @ p["wg"].to(dtype)) * h
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form


def apply_mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    return mlp_hidden(p, x, act) @ p["wd"].to(x.dtype)
