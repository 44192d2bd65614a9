"""Model assembly for decoder LMs of attention blocks (attn / swa / local).

Port of ``repro/models/transformer.py``.  The reference scans stacked layer
groups with ``lax.scan``; here ``forward`` is a Python loop over the
layers.  The parameter tree mirrors the reference's unstacked form:

  {"embed": {"embed"}, "groups": [{"pos0": block, ...}, ...],
   "tail": [block, ...], "final_norm": {"scale"}, "head"}

where a block is {"ln1", "attn": {wq wk wv wo}, "ln2", "mlp": {wi [wg] wd}}.
Caches mirror it too: {"groups": [{"pos0": {"self": paged cache}}], "tail"}.

Public API:
  init_params(cfg, gen, device)                     -> params tree
  forward(cfg, pcfg, params, tokens, ...)           -> (logits, aux, cache|None)
  prefill(cfg, pcfg, params, tokens, cache_len=...) -> (logits, cache)
  decode_step(cfg, pcfg, params, cache, token, positions) -> (logits, cache)
  cache_shapes(cfg, pcfg, batch, prompt_len, cache_len)   -> meta-tensor tree
  Transformer(cfg, params)                          -> nn.Module holding them
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ATTN_KINDS, ModelConfig, ParallelismConfig
from repro_torch.core.layout import _skeleton, _unflatten, tree_paths
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    apply_head,
    apply_norm,
    embed_tokens,
    embedding_init,
    head_init,
    norm_init,
)
from repro_torch.models.mlp import apply_mlp, mlp_init

# Leaves the reference casts to the compute dtype at every use
# (``x @ p["wq"].astype(dtype)``, ``p["embed"].astype(dtype)[tokens]``).
COMPUTE_CAST_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg", "wd", "embed")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported; the port runs {ATTN_KINDS}"
        )


def _block_init(gen, cfg: ModelConfig, kind: str, device) -> Dict:
    _check_kind(kind)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": norm_init(d, cfg.norm, device),
        "attn": attn_mod.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, device),
        "ln2": norm_init(d, cfg.norm, device),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, device),
    }


def _block_apply(cfg: ModelConfig, pcfg: ParallelismConfig, kind: str, p: Dict, x, *,
                 q_pos, cache, mode, cache_len, implicit_layout, q_seg, seg_base):
    window = cfg.sliding_window if kind in ("swa", "local") else 0
    eff_cache_len = min(cache_len, window) if (window and cache_len) else cache_len
    h = apply_norm(p["ln1"], x, cfg.norm)
    out, c_self = attn_mod.attention(
        p["attn"], h,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        q_pos=q_pos, rope_theta=cfg.rope_theta, causal=cfg.causal, window=window,
        cache=None if cache is None else cache["self"], mode=mode,
        attn_chunk=pcfg.attn_chunk, cache_len=eff_cache_len, backend=pcfg.backend,
        implicit_layout=implicit_layout, q_seg=q_seg, seg_base=seg_base,
    )
    x = x + out
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    return x, (None if mode == "train" else {"self": c_self})


class _RematGroup(torch.autograd.Function):
    """One layer group whose activations are recomputed in the backward, in
    a form that composes with ``torch.func`` as well as plain autograd
    (``torch.utils.checkpoint`` relies on saved-tensor hooks, which
    ``torch.func.grad`` refuses).

    ``fn(x, *leaves, *consts)``: the group's leaves are flat tensor
    arguments, and so are the tensors it reads besides (positions,
    segments), since a tensor made under a transform may not be captured.
    Forward runs the group and keeps only its inputs; backward recomputes it
    under ``torch.func.vjp`` and pulls the cotangent back to x and the
    leaves.  Under ``vmap`` torch generates the batching rule (the
    recompute is then vmapped too)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_consts, x, *args):
        return fn(x, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.n_consts = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        n_var = len(saved) - ctx.n_consts
        consts = saved[n_var:]
        _, pullback = torch.func.vjp(lambda *v: ctx.fn(*v, *consts), *saved[:n_var])
        return (None, None, *pullback(dy), *(None,) * ctx.n_consts)


def remat(group_fn, x, gp: Dict, *consts):
    """``group_fn(x, gp, *consts)`` with its activations recomputed in the
    backward; ``consts`` are tensors (or None) that take no gradient.  One
    form for every stats method (``_RematGroup``): the group's forward runs
    twice and its backward once."""
    skel = _skeleton(gp)
    leaves = [leaf for _, leaf in tree_paths(gp)]
    given = [c for c in consts if c is not None]

    def flat_fn(xx, *args):
        it = iter(args[len(leaves):])
        return group_fn(xx, _unflatten(skel, args[:len(leaves)]),
                        *(None if c is None else next(it) for c in consts))

    return _RematGroup.apply(flat_fn, len(given), x, *leaves, *given)


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cpu") -> Dict:
    """Seeded random params with the reference's init distribution (normal,
    std 1/sqrt(fan_in); norm scales 1), in f32, drawn from ``gen``."""
    for kind in cfg.pattern_layers():
        _check_kind(kind)
    params: Dict[str, Any] = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device)}
    params["groups"] = [
        {f"pos{i}": _block_init(gen, cfg, kind, device) for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.n_groups())
    ]
    params["tail"] = [_block_init(gen, cfg, kind, device) for kind in cfg.tail_kinds()]
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, device)
    if not cfg.tie_embeddings:
        params.update(head_init(gen, cfg.d_model, cfg.vocab_size, device))
    return params


def _layers(cfg: ModelConfig, params: Dict, cache: Optional[Dict]):
    """(kind, block params, block cache) in layer order."""
    for gi, gp in enumerate(params["groups"]):
        for i, kind in enumerate(cfg.block_pattern):
            yield kind, gp[f"pos{i}"], None if cache is None else cache["groups"][gi][f"pos{i}"]
    for ti, kind in enumerate(cfg.tail_kinds()):
        yield kind, params["tail"][ti], None if cache is None else cache["tail"][ti]


def forward(
    cfg: ModelConfig,
    pcfg: ParallelismConfig,
    params: Dict,
    tokens: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,
    segments: Optional[torch.Tensor] = None,
    seg_base: Optional[torch.Tensor] = None,
    cache_len: int = 0,
    last_only: bool = False,
    gather_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict, Optional[Dict]]:
    """tokens (B, S) -> (logits f32, aux, cache).

    positions: None (arange), (B,) offsets or (B, S) explicit; segments:
    (B, S) explicit segment ids (None = derived from positions); seg_base:
    (B,) offset into a cache row's segment numbering; gather_idx: (B, L)
    per-row token indices to unembed, which overrides last_only.  A cache
    passed with mode="prefill" is appended to.  In mode "train" with
    autograd on and ``pcfg.remat``, each layer group runs under ``remat``
    (recomputed in the backward), as the reference wraps its scanned group
    in ``jax.checkpoint``; the tail is not
    rematerialized there either.  aux is empty: no MoE block is ported."""
    dtype = getattr(torch, pcfg.compute_dtype)
    b, s = tokens.shape
    implicit_layout = positions is None
    ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if positions is None:
        q_pos = ar[None, :].expand(b, s)
    elif positions.ndim == 1:
        q_pos = positions.to(torch.int32)[:, None] + ar[None, :]
    else:
        q_pos = positions.to(torch.int32)
    use_cache_in = cache is not None and mode in ("decode", "prefill")

    x = embed_tokens(params["embed"], tokens, dtype)
    kw = dict(q_pos=q_pos, mode=mode, cache_len=cache_len, implicit_layout=implicit_layout,
              q_seg=segments, seg_base=seg_base)
    layer_caches = []
    if mode == "train" and pcfg.remat and torch.is_grad_enabled():
        # the counterpart of jax.checkpoint around each scanned layer group:
        # a group's activations are recomputed in the backward
        def group_fn(xx, gp, q_pos, q_seg, seg_base):
            for i, kind in enumerate(cfg.block_pattern):
                xx, _ = _block_apply(cfg, pcfg, kind, gp[f"pos{i}"], xx, cache=None,
                                     **{**kw, "q_pos": q_pos, "q_seg": q_seg,
                                        "seg_base": seg_base})
            return xx

        for gp in params["groups"]:
            x = remat(group_fn, x, gp, q_pos, segments, seg_base)
        for kind, p in zip(cfg.tail_kinds(), params["tail"]):
            x, _ = _block_apply(cfg, pcfg, kind, p, x, cache=None, **kw)
    else:
        for kind, p, blk_cache in _layers(cfg, params, cache if use_cache_in else None):
            x, nc = _block_apply(cfg, pcfg, kind, p, x, cache=blk_cache, **kw)
            layer_caches.append(nc)

    if gather_idx is not None:
        idx = gather_idx.long()[:, :, None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    elif last_only:
        x = x[:, -1:]
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x.float() @ params["embed"]["embed"].float().T
    else:
        logits = apply_head(params, x, cfg.logit_softcap)

    out_cache = None
    if mode in ("prefill", "decode"):
        n_pat = len(cfg.block_pattern)
        n_grouped = cfg.n_groups() * n_pat
        out_cache = {
            "groups": [
                {f"pos{i}": layer_caches[gi * n_pat + i] for i in range(n_pat)}
                for gi in range(cfg.n_groups())
            ],
            "tail": layer_caches[n_grouped:],
        }
    return logits, {}, out_cache


def prefill(cfg, pcfg, params, tokens, *, cache_len: int, cache=None, positions=None,
            segments=None, seg_base=None, gather_idx=None):
    """(logits, cache): logits (B,1,V) at the last position, or (B,L,V) at
    gather_idx (B, L).  A given ``cache`` is appended to (continuous
    batching) instead of building a fresh one."""
    logits, _aux, cache = forward(
        cfg, pcfg, params, tokens, mode="prefill", cache_len=cache_len, cache=cache,
        positions=positions, segments=segments, seg_base=seg_base, last_only=True,
        gather_idx=gather_idx,
    )
    return logits, cache


def decode_step(cfg, pcfg, params, cache, token, positions, segments=None):
    """token: (B,) or (B, L) (L lock-step lanes); positions: (B,) or (B, L)
    absolute position of each token, -1 for idle lanes; segments: optional
    (B,)/(B, L) row-global segment ids (None = segment 0, right only for
    single-document rows).  Consumes ``cache`` (written in place)."""
    if token.ndim == 1:
        token = token[:, None]
    pos = positions if positions.ndim == 2 else positions[:, None]
    seg = None
    if segments is not None:
        seg = segments if segments.ndim == 2 else segments[:, None]
    logits, _aux, cache = forward(cfg, pcfg, params, token, mode="decode", cache=cache,
                                  positions=pos, segments=seg)
    return logits, cache


def cache_shapes(cfg: ModelConfig, pcfg: ParallelismConfig, batch: int, prompt_len: int,
                 cache_len: int):
    """The decode-input cache tree as meta tensors (shapes and dtypes, no
    storage); prompt_len does not change them (kept for the reference's
    signature)."""
    del prompt_len
    dtype = getattr(torch, pcfg.compute_dtype)
    hd = cfg.resolved_head_dim

    def one(kind):
        window = cfg.sliding_window if kind in ("swa", "local") else 0
        c = min(cache_len, window) if (window and cache_len) else cache_len
        return {"self": attn_mod.empty_cache(batch, c, cfg.n_kv_heads, hd, dtype, "meta")}

    return {
        "groups": [{f"pos{i}": one(kind) for i, kind in enumerate(cfg.block_pattern)}
                   for _ in range(cfg.n_groups())],
        "tail": [one(kind) for kind in cfg.tail_kinds()],
    }


def _fill(m: nn.Module, tree: Dict) -> nn.Module:
    for k, val in tree.items():
        if isinstance(val, torch.Tensor):
            m.register_parameter(k, nn.Parameter(val))
        elif isinstance(val, (list, tuple)):
            m.add_module(k, nn.ModuleList([_fill(nn.Module(), t) for t in val]))
        else:
            m.add_module(k, _fill(nn.Module(), val))
    return m


def _to_tree(m: nn.Module, cast):
    """The params tree of ``m`` with ``cast(name, param)`` at each leaf."""
    if isinstance(m, nn.ModuleList):
        return [_to_tree(c, cast) for c in m]
    out = {k: cast(k, p) for k, p in m.named_parameters(recurse=False)}
    out.update({k: _to_tree(c, cast) for k, c in m.named_children()})
    return out


class Transformer(nn.Module):
    """Holds a params tree as module parameters.  Parameter names are the
    reference checkpoint paths with '/' -> '.' and the stacked group axis
    split out (``groups/pos0/attn/wq``[i] -> ``groups.i.pos0.attn.wq``).
    The parameters take gradients; ``forward`` serves from the cached
    compute-dtype copy.  Training runs the functional ``forward`` over a
    FlatParams tree (train/trainer.py), which casts the f32 weights to the
    compute dtype at every call, as the reference does."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self._compute: Dict[torch.dtype, Dict] = {}
        _fill(self, params)

    def compute_params(self, dtype: torch.dtype) -> Dict:
        """The params tree with the projection and embedding weights cast to
        ``dtype`` once, detached.  The reference casts them at every call;
        the values are identical, the copy saves the per-call cast.  Cached
        per dtype: a snapshot for serving, stale once the parameters are
        updated, so training never reads it."""
        if dtype not in self._compute:
            # a tied table also feeds the f32 head, so it keeps its dtype
            leaves = set(COMPUTE_CAST_LEAVES) - ({"embed"} if self.cfg.tie_embeddings else set())
            self._compute[dtype] = _to_tree(
                self, cast=lambda k, p: p.detach().to(dtype) if k in leaves else p.detach()
            )
        return self._compute[dtype]

    def _apply(self, fn, recurse=True):
        self._compute.clear()  # a move or cast invalidates the cached copies
        return super()._apply(fn, recurse)

    def forward(self, pcfg: ParallelismConfig, tokens: torch.Tensor, **kw):
        return forward(self.cfg, pcfg, self.compute_params(getattr(torch, pcfg.compute_dtype)),
                       tokens, **kw)
