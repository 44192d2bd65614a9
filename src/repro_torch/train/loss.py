"""Losses: next-token / MLM cross-entropy.

Port of ``repro/train/loss.py``.  Packed batches (several documents per
row, pads at position -1) support two normalizations, chosen by
``Config.loss_norm``: "token" (mean NLL over live tokens) and "document"
(every packed document contributes its own token-mean NLL with equal
weight).  Packed batches also report ``pack_efficiency`` (live tokens /
slots).  The port's model has no MoE block, so there is no auxiliary loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import Config
from repro_torch.kernels.flash_attention import segment_ids_from_positions
from repro_torch.models import forward


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits, targets, mask: Optional[torch.Tensor] = None):
    """logits (B,S,V) f32, targets (B,S) int -> scalar mean CE over mask."""
    nll = _nll(logits, targets)
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def document_cross_entropy(logits, targets, segments, mask: Optional[torch.Tensor] = None):
    """Segment-weighted CE for packed rows: mean over documents of each
    document's token-mean NLL.  Documents are keyed by (row, segment);
    negative segment ids (pads) weigh 0."""
    nll = _nll(logits, targets)
    b, s = targets.shape
    m = torch.ones((b, s), device=nll.device) if mask is None else mask.float()
    m = m * (segments >= 0)
    key = (segments.long() + s * torch.arange(b, device=nll.device)[:, None]).reshape(-1)
    key = torch.clamp(key, min=0)  # pad keys weigh 0 anyway
    doc_tok = torch.zeros(b * s, device=nll.device).index_add_(0, key, m.reshape(-1))
    doc_nll = torch.zeros(b * s, device=nll.device).index_add_(0, key, (nll * m).reshape(-1))
    live = doc_tok > 0
    per_doc = torch.where(live, doc_nll / torch.clamp(doc_tok, min=1.0), 0.0)
    return torch.sum(per_doc) / torch.clamp(torch.sum(live.float()), min=1.0)


def make_loss_fn(cfg: Config):
    """loss_fn(params, batch) -> (loss, metrics) for the trainer / grad_stats.

    batch: {"tokens": (B,S) int, "targets": (B,S) int, optional "mask",
    optional "positions" (B,S) int32 (packed/offset layouts; pads carry
    position -1 and are masked out of the loss), optional "segments"}."""
    m, p = cfg.model, cfg.parallel
    loss_norm = cfg.loss_norm
    if loss_norm not in ("token", "document"):
        raise ValueError(f"Config.loss_norm={loss_norm!r}: must be 'token' or 'document'")

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        positions = batch.get("positions")
        logits, _aux, _ = forward(m, p, params, batch["tokens"], mode="train",
                                  positions=positions)
        mask = batch.get("mask")
        packed = positions is not None and positions.ndim == 2
        if mask is None and packed:
            mask = positions >= 0
        if loss_norm == "document" and packed:
            segments = batch.get("segments")
            if segments is None:
                segments = segment_ids_from_positions(positions)
            ce = document_cross_entropy(logits, batch["targets"], segments, mask)
        else:
            ce = cross_entropy(logits, batch["targets"], mask)
        metrics = {"ce": ce.detach()}
        if packed:
            metrics["pack_efficiency"] = torch.mean((positions >= 0).float())
        return ce, metrics

    return loss_fn
