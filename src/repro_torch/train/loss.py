"""Losses: next-token / MLM cross-entropy.

Port of ``repro/train/loss.py``.  Packed batches (several documents per
row, pads at position -1) support two normalizations, chosen by
``Config.loss_norm``: "token" (mean NLL over live tokens) and "document"
(every packed document contributes its own token-mean NLL with equal
weight).  Packed batches also report ``pack_efficiency`` (live tokens /
slots).  The loss adds the MoE router's load-balance and z losses (zero
without MoE) to the cross-entropy, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import Config
from repro_torch.core.accumulate import LOSS_DENOM
from repro_torch.kernels.flash_attention import segment_ids_from_positions
from repro_torch.models import forward
from repro_torch.models.transformer import forward_grid


def _nll(logits: torch.Tensor, targets: torch.Tensor, placement=None) -> torch.Tensor:
    if placement is not None and placement.vocab_tp:
        return vocab_parallel_nll(logits, targets, placement)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, placement) -> torch.Tensor:
    """Per-token NLL from the rank's vocab columns of the logits (a
    sharding/placement.py::Placement that splits the vocab over its model
    axis; the rank's columns start at ``placement.vocab_offset()``): the
    row max, the sum of exponentials and the target logit each take one
    all-reduce over the model axis (max; then sums whose backward is the
    identity), and every model rank returns the whole NLL,
    log(sum exp(z - max)) + max - z_target, as ``torch.logsumexp`` forms it."""
    z = logits.float()
    v = z.shape[-1]
    top = placement.mesh.all_reduce_(z.detach().amax(dim=-1).contiguous(), placement.tp,
                                     op="max")
    sumexp = placement.reduce(torch.exp(z - top[..., None]).sum(dim=-1))
    local = targets.long() - placement.vocab_offset()
    inside = (local >= 0) & (local < v)
    gold = torch.gather(z, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = placement.reduce(torch.where(inside, gold, 0.0))
    return torch.log(sumexp) + top - gold


def token_count(targets, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token-mean CE's denominator: the mask's sum (at least 1), or
    every target."""
    if mask is None:
        return torch.tensor(float(targets.numel()), device=targets.device)
    return torch.clamp(torch.sum(mask.float()), min=1.0)


def cross_entropy(logits, targets, mask: Optional[torch.Tensor] = None,
                  denom: Optional[torch.Tensor] = None, placement=None):
    """logits (B,S,V) f32, targets (B,S) int -> scalar mean CE over mask;
    ``denom`` replaces the mask's own count (``token_count``).  With a
    ``placement`` that splits the vocab, logits are the rank's columns
    (``vocab_parallel_nll``)."""
    nll = _nll(logits, targets, placement)
    if denom is None and mask is None:
        return torch.mean(nll)
    total = torch.sum(nll) if mask is None else torch.sum(nll * mask.float())
    return total / (token_count(targets, mask) if denom is None else denom)


def _documents(targets, segments, mask):
    """(key, weight) of every token: its document's slot (row, segment)
    and its weight, 0 for pads and masked tokens."""
    b, s = targets.shape
    m = torch.ones((b, s), device=targets.device) if mask is None else mask.float()
    m = m * (segments >= 0)
    key = (segments.long() + s * torch.arange(b, device=targets.device)[:, None]).reshape(-1)
    return torch.clamp(key, min=0), m.reshape(-1)  # pad keys weigh 0 anyway


def document_count(targets, segments, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The document-mean CE's denominator: live documents (at least 1)."""
    key, m = _documents(targets, segments, mask)
    doc_tok = torch.zeros(m.numel(), device=m.device).index_add(0, key, m)
    return torch.clamp(torch.sum((doc_tok > 0).float()), min=1.0)


def document_cross_entropy(logits, targets, segments, mask: Optional[torch.Tensor] = None,
                           denom: Optional[torch.Tensor] = None, placement=None):
    """Segment-weighted CE for packed rows: mean over documents of each
    document's token-mean NLL.  Documents are keyed by (row, segment);
    negative segment ids (pads) weigh 0.  ``denom`` replaces the live
    document count (``document_count``); ``placement`` as for
    ``cross_entropy``."""
    nll = _nll(logits, targets, placement)
    key, m = _documents(targets, segments, mask)
    # out of place: torch.func.vmap refuses an in-place add of a batched
    # tensor into an unbatched one
    zeros = torch.zeros(m.numel(), device=nll.device)
    doc_tok = zeros.index_add(0, key, m)
    doc_nll = zeros.index_add(0, key, nll.reshape(-1) * m)
    live = doc_tok > 0
    per_doc = torch.where(live, doc_nll / torch.clamp(doc_tok, min=1.0), 0.0)
    if denom is None:
        denom = torch.clamp(torch.sum(live.float()), min=1.0)
    return torch.sum(per_doc) / denom


def make_loss_fn(cfg: Config, placement=None):
    """loss_fn(params, batch) -> (loss, metrics) for the trainer / grad_stats.

    batch: {"tokens": (B,S) int, "targets": (B,S) int, optional "mask",
    optional "positions" (B,S) int32 (packed/offset layouts; pads carry
    position -1 and are masked out of the loss), optional "segments",
    optional "image" (B,N,d) / "frames" (B,F,d) (the cross-attention's
    source), optional ``LOSS_DENOM``: the mean's denominator in place of
    the batch's own count}.  The loss is ce + moe_lb_loss + moe_z_loss;
    metrics {"ce", moe_lb_loss, moe_z_loss, moe_util[, pack_efficiency]}.  ``loss_fn.denominator(batch)`` is that count: under a mesh
    core/accumulate.py hands each rank its group's global count / W, so the
    ranks' losses average to the group's loss over all its rows (the
    reference's ``pjit`` mean), however the pads fall on the ranks.

    With a ``placement`` (sharding/placement.py::Placement of a GridMesh)
    ``params`` is a core/layout.py::GridParams tree and the forward is
    models/transformer.py::forward_grid; the cross-entropy is
    vocab-parallel when the placement splits the vocab, and every loss and
    metric comes out as the single-device loss gives it on the rank's rows.
    ``loss_fn.placement`` is the placement (None without one)."""
    m, p = cfg.model, cfg.parallel
    loss_norm = cfg.loss_norm
    if loss_norm not in ("token", "document"):
        raise ValueError(f"Config.loss_norm={loss_norm!r}: must be 'token' or 'document'")

    def masks(batch):
        """(positions, mask, packed, document segments or None)."""
        positions = batch.get("positions")
        mask = batch.get("mask")
        packed = positions is not None and positions.ndim == 2
        if mask is None and packed:
            mask = positions >= 0
        segments = None
        if loss_norm == "document" and packed:
            segments = batch.get("segments")
            if segments is None:
                segments = segment_ids_from_positions(positions)
        return positions, mask, packed, segments

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict]:
        positions, mask, packed, segments = masks(batch)
        if placement is not None:
            logits, aux = forward_grid(m, p, params, batch["tokens"], placement,
                                       positions=positions)
        else:
            extra = {name: batch[name] for name in ("image", "frames") if name in batch}
            logits, aux, _ = forward(m, p, params, batch["tokens"], extra=extra or None,
                                     mode="train", positions=positions)
        denom = batch.get(LOSS_DENOM)
        if segments is not None:
            ce = document_cross_entropy(logits, batch["targets"], segments, mask, denom,
                                        placement)
        else:
            ce = cross_entropy(logits, batch["targets"], mask, denom, placement)
        total = ce + aux["moe_lb_loss"] + aux["moe_z_loss"]
        metrics = {"ce": ce.detach(), **{k: v.detach() for k, v in aux.items()}}
        if packed:
            metrics["pack_efficiency"] = torch.mean((positions >= 0).float())
        return total, metrics

    def denominator(batch) -> torch.Tensor:
        """The loss's denominator over ``batch``: its live tokens, or its
        live documents under the document norm."""
        _, mask, _, segments = masks(batch)
        if segments is not None:
            return document_count(batch["targets"], segments, mask)
        return token_count(batch["targets"], mask)

    loss_fn.denominator = denominator
    loss_fn.placement = placement
    return loss_fn
