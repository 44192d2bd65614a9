"""DLRM (Naumov & Mudigere 2020) — the paper's Table-5 CTR benchmark.

Port of ``repro/models/dlrm.py``: plain functions on tensors.  Sparse
embedding tables + bottom MLP over dense features + pairwise dot-product
feature interaction + top MLP -> click logit (BCE loss).

The parameters are the reference's tree: ``tables`` one (n_sparse, T, D)
leaf, ``bottom`` and ``top`` lists of ``{"wi", "bias"}``.  Their flat
layout (core/layout.py::FlatParams with one group) is therefore the
reference's ``ParamLayout.for_tree``, and every table row of width 128 is
one flat row.  The embedding gather's gradient is dense, as the reference's
(the transpose of a gather is a scatter-add into a table-sized zero), so a
step carries the whole tables leaf through the moments and the update.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.models.common import normal_init


def _mlp_init(gen: torch.Generator, dims: Tuple[int, ...], in_dim: int, device) -> list:
    layers = []
    for d in dims:
        layers.append({"wi": normal_init(gen, (in_dim, d), device=device),
                       "bias": torch.zeros(d, device=device)})
        in_dim = d
    return layers


def _mlp_apply(layers: list, x: torch.Tensor, final_linear: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["wi"] + layer["bias"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def init_params(cfg: DLRMConfig, gen: torch.Generator, device="cpu") -> Dict:
    """Seeded N(0, 1/fan_in) weights (tables: fan_in = embedding_dim) and zero
    biases in the reference's tree; the draws come from ``gen``."""
    n_emb = cfg.n_sparse_features
    num_int = (n_emb + 1) * n_emb // 2  # pairwise dots among (bottom + embeddings)
    top_in = cfg.bottom_mlp[-1] + num_int
    return {
        "tables": normal_init(gen, (n_emb, cfg.table_size, cfg.embedding_dim),
                              fan_in=cfg.embedding_dim, device=device),
        "bottom": _mlp_init(gen, cfg.bottom_mlp, cfg.n_dense_features, device),
        "top": _mlp_init(gen, cfg.top_mlp, top_in, device),
    }


def params_from_numpy(tree, device="cpu") -> Dict:
    """The reference's DLRM tree with numpy leaves (e.g. ``jax.device_get``
    of ``repro.models.dlrm.init_params``) as the port's tree of f32 tensors
    on ``device`` (copies)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def interaction_pairs(f: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) of the strict upper triangle of an (f, f) matrix in
    ``jnp.triu_indices(f, k=1)``'s row-major order."""
    iu = torch.triu_indices(f, f, 1, device=device)
    return iu[0], iu[1]


def forward(cfg: DLRMConfig, params: Dict, dense: torch.Tensor,
            sparse: torch.Tensor) -> torch.Tensor:
    """dense: (B, n_dense) f32; sparse: (B, n_sparse) int -> logits (B,)."""
    bot = _mlp_apply(params["bottom"], dense, final_linear=False)  # (B, D)
    feat_idx = torch.arange(cfg.n_sparse_features, device=sparse.device)
    emb = params["tables"][feat_idx[None, :], sparse.long()]  # (B, n_sparse, D)
    feats = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F, D)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)  # (B, F, F)
    iu, ju = interaction_pairs(feats.shape[1], inter.device)
    flat = inter[:, iu, ju]  # (B, F(F-1)/2)
    top_in = torch.cat([bot, flat], dim=-1)
    logits = _mlp_apply(params["top"], top_in, final_linear=True)
    return logits[:, 0]


def bce_loss(cfg: DLRMConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean stable binary cross-entropy of the click logits."""
    logits = forward(cfg, params, batch["dense"], batch["sparse"])
    y = batch["label"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def loss_fn(cfg: DLRMConfig) -> Callable:
    """(params, batch) -> (bce_loss, {}): the form core/accumulate.py's
    ``grad_stats`` and ``grad_only`` take."""

    def fn(params: Dict, batch: Dict):
        return bce_loss(cfg, params, batch), {}

    return fn
