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


def mlp_hidden(p: Dict, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """The block's hidden activation, the input of its ``wd`` projection.
    With ``tp`` (a sharding/placement.py::Placement whose model axis splits
    d_ff) wi/wg are the rank's columns and the hidden activation its d_ff
    columns; the input is entered (``tp.col_product``)."""
    dtype = x.dtype
    if tp is not None:
        xe = tp.enter(x)
        proj = lambda w: tp.col_product(xe, w, dtype)
    else:
        proj = lambda w: x @ w.to(dtype)
    h = proj(p["wi"])
    if act == "swiglu":
        return F.silu(proj(p["wg"])) * h
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form


def apply_mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    return mlp_hidden(p, x, act) @ p["wd"].to(x.dtype)
