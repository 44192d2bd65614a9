"""Model assembly: decoder LMs, encoder-decoder (whisper), VLM cross-attention,
hybrid recurrent and xLSTM stacks, all driven by ``ModelConfig.block_pattern``.

Port of ``repro/models/transformer.py``.  The reference scans stacked layer
groups with ``lax.scan``; here ``forward`` is a Python loop over the
layers.  The parameter tree mirrors the reference's unstacked form:

  {"embed": {"embed"}, "groups": [{"pos0": block, ...}, ...],
   "tail": [block, ...], "final_norm": {"scale"}, "head",
   "encoder": {"layers": [block, ...], "final_norm"} (whisper),
   "img_proj" (vlm)}

where a block is {"ln1", "attn": {wq wk wv wo}, ["lnx", "xattn"], "ln2",
"mlp": {wi [wg] wd} | "moe": {...}} for attn/swa/local/xattn, {"ln1",
"rec", "ln2", "mlp" | "moe"} for rec, {"ln1", "mlstm"} and {"ln1",
"slstm"}.  Caches mirror it: {"groups": [{"pos0": block cache}], "tail",
"memory"}, a block cache being {"self": paged cache[, "cross": {k, v,
kpos}]} for the attention kinds, the RG-LRU's {"h", "conv"} and the
xLSTM cells' {"conv", "state"}.

Public API:
  init_params(cfg, gen, device)                     -> params tree
  forward(cfg, pcfg, params, tokens, ...)           -> (logits, aux, cache|None)
  prefill(cfg, pcfg, params, tokens, cache_len=...) -> (logits, cache)
  decode_step(cfg, pcfg, params, cache, token, positions) -> (logits, cache)
  encode(cfg, pcfg, params, frames)                 -> encoder memory (whisper)
  cache_shapes(cfg, pcfg, batch, prompt_len, cache_len)   -> meta-tensor tree
  Transformer(cfg, params)                          -> nn.Module holding them
  forward_grid(cfg, pcfg, tree, tokens, placement)  -> (logits, aux) of one rank
                                                       of a GridMesh (train)
  model_layout(cfg)                                 -> the stacked flat layout
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import BLOCK_KINDS, ModelConfig, ParallelismConfig
from repro_torch.core.layout import (ParamLayout, _skeleton, _unflatten, nest_paths,
                                     stack_groups, tree_map, tree_paths)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xl_mod
from repro_torch.models.common import (
    apply_head,
    apply_norm,
    embed_tokens,
    embedding_init,
    head_init,
    norm_init,
    normal_init,
)
from repro_torch.models.mlp import mlp_hidden, mlp_init
from repro_torch.sharding.rules import constrain

# Leaves the reference casts to the compute dtype at every use
# (``x @ p["wq"].astype(dtype)``, ``p["embed"].astype(dtype)[tokens]``).
# Not a_log, xl_if_b, sl_b and sl_r, which it adds or uses in f32.
COMPUTE_CAST_LEAVES = (
    "wq", "wk", "wv", "wo", "wi", "wg", "wd", "embed",
    "router", "expert_wi", "expert_wg", "expert_wd",
    "w_y", "w_gatein", "w_rg_a", "w_rg_x", "w_out", "conv_w",
    "xl_up", "xl_conv", "xl_q", "xl_k", "xl_v", "xl_if", "xl_down",
    "sl_conv", "sl_w", "sl_up", "sl_upg", "sl_down", "img_proj",
)
ATTN_FAMILY = ("attn", "swa", "local", "xattn")
AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_util")


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; known: {BLOCK_KINDS}")


def _ffn_init(gen, cfg: ModelConfig, device) -> Tuple[str, Dict]:
    if cfg.moe is not None:
        return "moe", moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.moe, device)
    return "mlp", mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device)


def _block_init(gen, cfg: ModelConfig, kind: str, device) -> Dict:
    _check_kind(kind)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p: Dict[str, Any] = {"ln1": norm_init(d, cfg.norm, device)}
    if kind in ATTN_FAMILY:
        p["attn"] = attn_mod.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, device)
        if kind == "xattn":
            p["lnx"] = norm_init(d, cfg.norm, device)
            p["xattn"] = attn_mod.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, hd, device)
    elif kind == "rec":
        p["rec"] = rec_mod.rglru_init(gen, d, device)
    elif kind == "mlstm":
        p["mlstm"] = xl_mod.mlstm_init(gen, d, cfg.n_heads, cfg.qk_dim_factor, device)
        return p
    else:
        p["slstm"] = xl_mod.slstm_init(gen, d, cfg.n_heads, device)
        return p
    p["ln2"] = norm_init(d, cfg.norm, device)
    name, ffn = _ffn_init(gen, cfg, device)
    p[name] = ffn
    return p


def last_product(cfg: ModelConfig, kind: str) -> Optional[Tuple[str, str]]:
    """The path in a block of the weight whose product ends it (the
    block's output is ``x_res + hidden @ W``), or None when its last step
    is no single product (a mixture of experts)."""
    if kind == "mlstm":
        return ("mlstm", "xl_down")
    if kind == "slstm":
        return ("slstm", "sl_down")
    return None if cfg.moe is not None else ("mlp", "wd")


def _ffn(cfg: ModelConfig, p: Dict, x, tp=None):
    """(x_res, hidden, aux) of the block's feed-forward half (``tp``: the
    MLP's d_ff split over the model axis, hidden the rank's columns)."""
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    if "moe" in p:
        out, aux = moe_mod.apply_moe(p["moe"], h2, cfg.act, cfg.moe)
        return x + out, None, aux
    return x, mlp_hidden(p["mlp"], h2, cfg.act, tp=tp), None


def _block_body(cfg: ModelConfig, pcfg: ParallelismConfig, kind: str, p: Dict, x, *,
                q_pos, cache, mode, cache_len, implicit_layout, q_seg, seg_base,
                memory=None, causal=None, tp=None):
    """(x_res, hidden, cache, aux) of one block.  Its output is ``x_res +
    hidden @ W`` for W at ``last_product`` (read nowhere here), or x_res
    when hidden is None; aux holds the MoE readings, or is None.  ``tp``:
    one rank of a GridMesh (a sharding/placement.py::Placement; train, the
    dense kinds), whose model axis splits the heads and the MLP's d_ff
    where the placement says so (``attn_tp``, ``mlp_tp``)."""
    causal = cfg.causal if causal is None else causal
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind in ATTN_FAMILY:
        window = cfg.sliding_window if kind in ("swa", "local") else 0
        eff_cache_len = min(cache_len, window) if (window and cache_len) else cache_len
        tp_attn = tp if tp is not None and tp.attn_tp else None
        m = 1 if tp_attn is None else tp.m
        common = dict(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                      head_dim=cfg.resolved_head_dim, q_pos=q_pos, mode=mode,
                      attn_chunk=pcfg.attn_chunk, backend=pcfg.backend)
        out, c_self = attn_mod.attention(
            p["attn"], h, rope_theta=cfg.rope_theta, causal=causal, window=window,
            cache=None if cache is None else cache["self"], cache_len=eff_cache_len,
            implicit_layout=implicit_layout, q_seg=q_seg, seg_base=seg_base, tp=tp_attn,
            **common,
        )
        x = x + out
        new_cache = None if mode == "train" else {"self": c_self}
        if kind == "xattn":
            hx = apply_norm(p["lnx"], x, cfg.norm)
            out, c_cross = attn_mod.attention(
                p["xattn"], hx, memory=memory,
                cache=None if cache is None else cache["cross"], **common)
            x = x + out
            if new_cache is not None:
                new_cache["cross"] = c_cross
        x, hidden, aux = _ffn(cfg, p, x, tp=tp if tp is not None and tp.mlp_tp else None)
        return x, hidden, new_cache, aux
    if kind == "rec":
        out, new_cache = rec_mod.apply_rglru(p["rec"], h, cache=cache, mode=mode)
        x, hidden, aux = _ffn(cfg, p, x + out)
        return x, hidden, new_cache, aux
    if kind == "mlstm":
        hidden, new_cache = xl_mod.apply_mlstm(p["mlstm"], h, cfg.n_heads, cache=cache, mode=mode)
    else:
        hidden, new_cache = xl_mod.apply_slstm(p["slstm"], h, cfg.n_heads, cache=cache, mode=mode)
    return x, hidden, new_cache, None


def _leaf(p: Dict, path):
    for key in path:
        p = p[key]
    return p


def _block_apply(cfg: ModelConfig, pcfg: ParallelismConfig, kind: str, p: Dict, x, tp=None,
                 **kw):
    """(x, cache, aux) of one block (``tp`` as for ``_block_body``: the
    last product is then the row product summed over the model axis)."""
    x, hidden, c, aux = _block_body(cfg, pcfg, kind, p, x, tp=tp, **kw)
    if hidden is not None:
        w = _leaf(p, last_product(cfg, kind))
        if tp is not None and tp.mlp_tp:
            x = x + tp.row_product(hidden, w)
        else:
            x = x + hidden @ w.to(x.dtype)
    return constrain(x, ("batch", None, None)), c, aux


def _aux_zero(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _aux_add(total: Dict, aux: Optional[Dict]) -> Dict:
    if aux is None:
        return total
    return {k: total[k] + aux[k] for k in total}


class _RematGroup(torch.autograd.Function):
    """One layer group whose activations are recomputed in the backward, in
    a form that composes with ``torch.func`` as well as plain autograd
    (``torch.utils.checkpoint`` relies on saved-tensor hooks, which
    ``torch.func.grad`` refuses).

    ``fn(x, *leaves, *consts) -> (x_res, h)`` is the group's body up to its
    last projection: the group's output is ``x_res + h @ wd`` (the last
    block's closing product and residual add: the MLP's ``wd``, the
    mLSTM's ``xl_down`` or the sLSTM's ``sl_down``, ``last_product``).  The
    leaves (all but ``wd``) are flat tensor arguments, and so are the tensors it reads
    besides (positions, segments), since a tensor made under a transform
    may not be captured.  Forward runs the group and keeps only its
    inputs; backward recomputes the body alone under ``torch.func.vjp``
    (the last product is not rerun: its backward needs only h), forms the
    last product's gradients as autograd would (``dh = dy wd^T``,
    ``dwd = h^T dy`` cast to wd's dtype, ``dx_res = dy``) and pulls
    ``(dx_res, dh)`` back to x and the leaves.  Under ``vmap`` torch
    generates the batching rule (the recompute is then vmapped too)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_consts, x, wd, *args):
        x_res, h = fn(x, *args)
        return x_res + h @ wd.to(h.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.n_consts = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, wd, *rest = ctx.saved_tensors
        n_var = len(rest) - ctx.n_consts
        consts = rest[n_var:]
        (_, h), pullback = torch.func.vjp(lambda *v: ctx.fn(*v, *consts), x, *rest[:n_var])
        # the backward of matmul(h, wd.to(dtype)): mm on the flattened rows
        dy2 = dy.reshape(-1, dy.shape[-1])
        dh = (dy2 @ wd.to(h.dtype).T).reshape(h.shape)
        dwd = (h.reshape(-1, h.shape[-1]).T @ dy2).to(wd.dtype)
        dx, *dleaves = pullback((dy, dh))
        return (None, None, dx, dwd, *dleaves, *(None,) * ctx.n_consts)


class _RematWhole(torch.autograd.Function):
    """A layer group that ends in no single product (its last block is a
    mixture of experts), recomputed whole in the backward, in the form of
    ``_RematGroup``.  ``fn(x, *leaves, *consts) -> (y, aux)``: the group's
    output and its (3,) MoE readings, both differentiable (the load-balance
    and z losses enter the loss).  Backward reruns the body under
    ``torch.func.vjp`` and pulls ``(dy, daux)`` back to x and the leaves."""

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
    def backward(ctx, dy, daux):
        x, *rest = ctx.saved_tensors
        n_var = len(rest) - ctx.n_consts
        consts = rest[n_var:]
        _, pullback = torch.func.vjp(lambda *v: ctx.fn(*v, *consts), x, *rest[:n_var])
        dx, *dleaves = pullback((dy, daux))
        return (None, None, dx, *dleaves, *(None,) * ctx.n_consts)


def remat(group_body, x, gp: Dict, wd_path: Optional[Tuple[str, ...]], *consts, inputs=()):
    """The group's output with the body's activations recomputed in the
    backward.  ``group_body(x, gp, *inputs, *consts)`` gives ``(x_res, h)``
    and the output is ``x_res + h @ gp[wd_path]`` (the body finds None at
    ``wd_path``; ``_RematGroup``: the body's forward runs twice, the last
    product once); with ``wd_path`` None it gives ``(y, aux)`` and both are
    returned (``_RematWhole``: the body's forward runs twice).  ``inputs``
    are tensors (or None) that take a gradient besides x (an encoder's
    memory), ``consts`` tensors (or None) that take none.  One form for
    every stats method."""
    skel = _skeleton(gp)
    wd_key = None if wd_path is None else "/".join(wd_path)
    paths = tree_paths(gp)
    leaves = [leaf for path, leaf in paths if path != wd_key]
    given_in = [t for t in inputs if t is not None]
    given = [c for c in consts if c is not None]
    n_leaves = len(leaves)

    def flat_fn(xx, *args):
        vals = iter(args[:n_leaves])
        ins = iter(args[n_leaves:n_leaves + len(given_in)])
        it = iter(args[n_leaves + len(given_in):])
        tree = [None if path == wd_key else next(vals) for path, _ in paths]
        return group_body(xx, _unflatten(skel, tree),
                          *(None if t is None else next(ins) for t in inputs),
                          *(None if c is None else next(it) for c in consts))

    if wd_key is None:
        return _RematWhole.apply(flat_fn, len(given), x, *leaves, *given_in, *given)
    wd = next(leaf for path, leaf in paths if path == wd_key)
    return _RematGroup.apply(flat_fn, len(given), x, wd, *leaves, *given_in, *given)


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cpu",
                dtype: torch.dtype = torch.float32) -> Dict:
    """Seeded random params with the reference's init distribution (normal,
    std 1/sqrt(fan_in); norm scales 1; the RG-LRU's and xLSTM's fixed gate
    inits), drawn in f32 from ``gen``.  With ``dtype`` bf16 each block's
    leaves (and the embedding and head) are rounded as soon as they are
    drawn, so the f32 draws of one block at a time are all that is held
    besides: granite-20b's 20 B params take 40.6 GB so, against 81 GB in
    f32.  The draws are the same for every dtype, so a bf16 tree holds the
    f32 tree's values rounded."""
    for kind in cfg.pattern_layers():
        _check_kind(kind)

    def cast(tree):
        return tree_map(lambda t: t.to(dtype), tree)

    params: Dict[str, Any] = {
        "embed": cast(embedding_init(gen, cfg.vocab_size, cfg.d_model, device))}
    params["groups"] = [
        {f"pos{i}": cast(_block_init(gen, cfg, kind, device))
         for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.n_groups())
    ]
    params["tail"] = [cast(_block_init(gen, cfg, kind, device)) for kind in cfg.tail_kinds()]
    params["final_norm"] = cast(norm_init(cfg.d_model, cfg.norm, device))
    if not cfg.tie_embeddings:
        params.update(cast(head_init(gen, cfg.d_model, cfg.vocab_size, device)))
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [cast(_block_init(gen, cfg, "attn", device))
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": cast(norm_init(cfg.d_model, cfg.norm, device)),
        }
    if cfg.n_image_tokens:
        params["img_proj"] = normal_init(gen, (cfg.d_model, cfg.d_model), device=device).to(dtype)
    return params


def _layers(cfg: ModelConfig, params: Dict, cache: Optional[Dict]):
    """(kind, block params, block cache) in layer order."""
    for gi, gp in enumerate(params["groups"]):
        for i, kind in enumerate(cfg.block_pattern):
            yield kind, gp[f"pos{i}"], None if cache is None else cache["groups"][gi][f"pos{i}"]
    for ti, kind in enumerate(cfg.tail_kinds()):
        yield kind, params["tail"][ti], None if cache is None else cache["tail"][ti]


def encode(cfg: ModelConfig, pcfg: ParallelismConfig, params: Dict, frames: torch.Tensor):
    """The encoder tower (whisper) over the stub frame embeddings (B, F, d):
    non-causal attn blocks on the implicit layout, then the final norm."""
    x = frames.to(getattr(torch, pcfg.compute_dtype))
    b, f, _ = x.shape
    pos = torch.arange(f, dtype=torch.int32, device=x.device)[None, :].expand(b, f)
    for lp in params["encoder"]["layers"]:
        x, _, _ = _block_apply(cfg, pcfg, "attn", lp, x, q_pos=pos, cache=None, mode="train",
                               cache_len=0, causal=False, implicit_layout=True, q_seg=None,
                               seg_base=None)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)


def _resolve_memory(cfg: ModelConfig, pcfg: ParallelismConfig, params: Dict, extra):
    """The cross-attention memory: the encoder over ``extra["frames"]``, or
    ``extra["image"] @ img_proj``; None for a model without either."""
    if cfg.encoder is not None:
        if extra is None or "frames" not in extra:
            raise ValueError("enc-dec model needs extra={'frames': (B,F,d)}")
        return encode(cfg, pcfg, params, extra["frames"])
    if cfg.n_image_tokens:
        if extra is None or "image" not in extra:
            raise ValueError("vlm needs extra={'image': (B,N,d)}")
        img = extra["image"].to(getattr(torch, pcfg.compute_dtype))
        return img @ params["img_proj"].to(img.dtype)
    return None


def _q_pos(tokens: torch.Tensor, positions: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S) int32 query positions: arange(S), (B,) offsets plus it, or
    the given (B, S)."""
    b, s = tokens.shape
    ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if positions is None:
        return ar[None, :].expand(b, s)
    if positions.ndim == 1:
        return positions.to(torch.int32)[:, None] + ar[None, :]
    return positions.to(torch.int32)


def forward(
    cfg: ModelConfig,
    pcfg: ParallelismConfig,
    params: Dict,
    tokens: torch.Tensor,
    *,
    extra: Optional[Dict] = None,
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

    extra: {"frames": (B, F, d)} (encoder-decoder) or {"image": (B, N, d)}
    (vlm), the cross-attention's source; a decode step reads the memory
    from ``cache["memory"]`` instead.  positions: None (arange), (B,)
    offsets or (B, S) explicit; segments: (B, S) explicit segment ids (None
    = derived from positions); seg_base: (B,) offset into a cache row's
    segment numbering; gather_idx: (B, L) per-row token indices to unembed,
    which overrides last_only.  A cache passed with mode="prefill" is
    appended to.  In mode "train" with autograd on and ``pcfg.remat``, each
    layer group runs under ``remat`` (recomputed in the backward), as the
    reference wraps its scanned group in ``jax.checkpoint``; the tail and
    the encoder are not rematerialized there either.  aux: the MoE
    readings {moe_lb_loss, moe_z_loss, moe_util} summed over the layers
    and divided by max(1, n_layers) (zeros without MoE)."""
    dtype = getattr(torch, pcfg.compute_dtype)
    implicit_layout = positions is None
    q_pos = _q_pos(tokens, positions)
    use_cache_in = cache is not None and mode in ("decode", "prefill")
    if mode == "decode" and cache is not None and "memory" in cache:
        memory = cache["memory"]
    else:
        memory = _resolve_memory(cfg, pcfg, params, extra)

    x = constrain(embed_tokens(params["embed"], tokens, dtype), ("batch", None, None))
    aux = _aux_zero(x.device)
    kw = dict(q_pos=q_pos, mode=mode, cache_len=cache_len, implicit_layout=implicit_layout,
              q_seg=segments, seg_base=seg_base, memory=memory)
    layer_caches = []
    if mode == "train" and pcfg.remat and torch.is_grad_enabled():
        # the counterpart of jax.checkpoint around each scanned layer group:
        # a group's activations are recomputed in the backward
        last = len(cfg.block_pattern) - 1
        # a group with MoE blocks returns their readings too: recomputed whole
        wd_path = None if cfg.moe is not None else last_product(cfg, cfg.block_pattern[last])

        def group_body(xx, gp, memory, q_pos, q_seg, seg_base):
            gkw = {**kw, "q_pos": q_pos, "q_seg": q_seg, "seg_base": seg_base, "memory": memory}
            gaux = _aux_zero(xx.device)
            for i, kind in enumerate(cfg.block_pattern[:last]):
                xx, _, a = _block_apply(cfg, pcfg, kind, gp[f"pos{i}"], xx, cache=None, **gkw)
                gaux = _aux_add(gaux, a)
            xx, h, _, a = _block_body(cfg, pcfg, cfg.block_pattern[last], gp[f"pos{last}"], xx,
                                      cache=None, **gkw)
            if wd_path is not None:
                return xx, h
            return xx, torch.stack([_aux_add(gaux, a)[k] for k in AUX_KEYS])

        for gi, gp in enumerate(params["groups"]):
            path = None if wd_path is None else (f"pos{last}", *wd_path)
            out = remat(group_body, x, gp, path, q_pos, segments, seg_base, inputs=(memory,))
            if wd_path is None:
                x, gaux = out
                aux = {k: aux[k] + gaux[i] for i, k in enumerate(AUX_KEYS)}
            else:
                x = out
        for kind, p in zip(cfg.tail_kinds(), params["tail"]):
            x, _, a = _block_apply(cfg, pcfg, kind, p, x, cache=None, **kw)
            aux = _aux_add(aux, a)
    else:
        for kind, p, blk_cache in _layers(cfg, params, cache if use_cache_in else None):
            x, nc, a = _block_apply(cfg, pcfg, kind, p, x, cache=blk_cache, **kw)
            aux = _aux_add(aux, a)
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

    n_layers = max(1, cfg.n_layers)
    aux = {k: v / n_layers for k, v in aux.items()}
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
        if memory is not None:
            out_cache["memory"] = memory
    return logits, aux, out_cache


class _RematGrid(torch.autograd.Function):
    """A layer group on a GridMesh, recomputed in the backward: ``fn(x,
    *leaves)`` gathers the group's weights from the rank's blocks on use
    (sharding/placement.py) and returns the group's output.  Forward runs it
    and keeps only its inputs (no gathered weight outlives the call);
    backward reruns it under autograd, gathering again, and pulls ``dy``
    back to x and the blocks, whose gathers' adjoints reduce the weight
    gradients into the rank's blocks.  Plain autograd only: ``_RematWhole``'s
    ``torch.func.vjp`` refuses the gathers' autograd Functions (they define
    no ``setup_context``), and the grid runs no ``torch.func`` transform."""

    @staticmethod
    def forward(ctx, fn, x, *leaves):
        ctx.fn = fn
        ctx.save_for_backward(x, *leaves)
        return fn(x, *leaves)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ctx.fn(*ins)
        want = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(y, want, dy, allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None for t in ins))


def forward_grid(cfg: ModelConfig, pcfg: ParallelismConfig, tree: Dict, tokens: torch.Tensor,
                 placement, *, positions: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """The train forward of one rank of a GridMesh: tokens (B, S) (the
    rank's rows) -> (f32 logits, aux).  ``tree`` is a core/layout.py::
    GridParams tree of the rank's weight blocks, ``placement`` its
    sharding/placement.py::Placement.  The logits are the rank's vocab
    columns when the placement splits the vocab (``placement.vocab_tp``;
    train/loss.py's vocab-parallel cross-entropy takes them), else the whole
    vocab.  The layer groups run under ``_RematGrid`` (with autograd on and
    ``pcfg.remat``), each group's weights gathered on use; a stacked leaf
    whose layer dim is split is gathered whole once per call.  The dense
    attention kinds only (``Placement`` refuses the others); aux holds the
    MoE readings, zero."""
    pl, whole = placement, tree["whole"]
    dtype = getattr(torch, pcfg.compute_dtype)
    kw = dict(q_pos=_q_pos(tokens, positions), cache=None, mode="train", cache_len=0,
              implicit_layout=positions is None, q_seg=None, seg_base=None, tp=pl)
    use = lambda path: pl.use(whole[path], path)
    x = constrain(pl.embed(use("embed/embed"), tokens, dtype), ("batch", None, None))

    from repro_torch.sharding.placement import group_path

    # leaves of the groups held whole: an unstacked group's, gathered in the
    # group's body; a stacked leaf with its layer dim split, gathered here
    held = {group_path(p, pl.stacked): p for p in whole if p.startswith("groups/")}
    pre = {name: use(path) for name, path in held.items() if pl.stacked}
    names = sorted(tree["groups"][0]) if tree["groups"] else []
    n_in = len(names)

    def body(xx, *leaves):
        flat = {name: pl.use(leaf, f"groups/{name}", 1) for name, leaf in zip(names, leaves)}
        for name, t in zip(sorted(held), leaves[n_in:]):
            flat[name] = t if pl.stacked else pl.use(t, held[name])
        gp = nest_paths(flat)
        for i, kind in enumerate(cfg.block_pattern):
            xx = _block_apply(cfg, pcfg, kind, gp[f"pos{i}"], xx, **kw)[0]
        return xx

    remat_on = pcfg.remat and torch.is_grad_enabled()
    for g, gp in enumerate(tree["groups"]):
        extra = [pre[n][g] if pl.stacked else whole[held[n]] for n in sorted(held)]
        args = [gp[n] for n in names] + extra
        x = _RematGrid.apply(body, x, *args) if remat_on else body(x, *args)
    for ti, kind in enumerate(cfg.tail_kinds()):
        prefix = f"tail/{ti}/"
        p = nest_paths({path[len(prefix):]: use(path) for path in whole
                        if path.startswith(prefix)})
        x = _block_apply(cfg, pcfg, kind, p, x, **kw)[0]
    x = apply_norm(nest_paths({path.split("/", 1)[1]: use(path) for path in whole
                               if path.startswith("final_norm/")}), x, cfg.norm)
    if cfg.tie_embeddings:
        logits = pl.logits(x, use("embed/embed"), tied=True)
    else:
        logits = pl.logits(x, use("head"), tied=False)
        if cfg.logit_softcap > 0:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, _aux_zero(x.device)


def model_layout(cfg: ModelConfig) -> ParamLayout:
    """The flat layout of ``cfg``'s stacked params (shapes only: the tree is
    drawn on the meta device)."""
    return ParamLayout.for_tree(stack_groups(init_params(cfg, None, device="meta")))


def prefill(cfg, pcfg, params, tokens, *, extra=None, cache_len: int, cache=None,
            positions=None, segments=None, seg_base=None, gather_idx=None):
    """(logits, cache): logits (B,1,V) at the last position, or (B,L,V) at
    gather_idx (B, L).  A given ``cache`` is appended to (continuous
    batching) instead of building a fresh one."""
    logits, _aux, cache = forward(
        cfg, pcfg, params, tokens, extra=extra, mode="prefill", cache_len=cache_len,
        cache=cache, positions=positions, segments=segments, seg_base=seg_base,
        last_only=True, gather_idx=gather_idx,
    )
    return logits, cache


def decode_step(cfg, pcfg, params, cache, token, positions, segments=None):
    """token: (B,) or (B, L) (L lock-step lanes); positions: (B,) or (B, L)
    absolute position of each token, -1 for idle lanes; segments: optional
    (B,)/(B, L) row-global segment ids (None = segment 0, right only for
    single-document rows).  Consumes ``cache`` (its attention caches are
    written in place)."""
    if token.ndim == 1:
        token = token[:, None]
    pos = positions if positions.ndim == 2 else positions[:, None]
    seg = None
    if segments is not None:
        seg = segments if segments.ndim == 2 else segments[:, None]
    logits, _aux, cache = forward(cfg, pcfg, params, token, mode="decode", cache=cache,
                                  positions=pos, segments=seg)
    return logits, cache


def memory_len(cfg: ModelConfig) -> int:
    """The cross-attention memory's length: the encoder's frames or the
    image tokens (0 without either)."""
    return cfg.encoder.n_frames if cfg.encoder is not None else cfg.n_image_tokens


def cache_shapes(cfg: ModelConfig, pcfg: ParallelismConfig, batch: int, prompt_len: int,
                 cache_len: int):
    """The decode-input cache tree as meta tensors (shapes and dtypes, no
    storage); prompt_len does not change them (kept for the reference's
    signature).  A cross-attention model's memory has ``memory_len(cfg)``
    rows."""
    del prompt_len
    dtype = getattr(torch, pcfg.compute_dtype)
    d, hd, kvh = cfg.d_model, cfg.resolved_head_dim, cfg.n_kv_heads
    mem = memory_len(cfg)

    def one(kind):
        if kind == "rec":
            return rec_mod.rglru_cache(batch, d, dtype, "meta")
        if kind == "mlstm":
            return xl_mod.mlstm_cache(batch, d, cfg.n_heads, cfg.qk_dim_factor, dtype, "meta")
        if kind == "slstm":
            return xl_mod.slstm_cache(batch, d, dtype, "meta")
        window = cfg.sliding_window if kind in ("swa", "local") else 0
        c = min(cache_len, window) if (window and cache_len) else cache_len
        out = {"self": attn_mod.empty_cache(batch, c, kvh, hd, dtype, "meta")}
        if kind == "xattn":
            out["cross"] = {
                "k": torch.empty((batch, mem, kvh, hd), dtype=dtype, device="meta"),
                "v": torch.empty((batch, mem, kvh, hd), dtype=dtype, device="meta"),
                "kpos": torch.empty((batch, mem), dtype=torch.int32, device="meta"),
            }
        return out

    out = {
        "groups": [{f"pos{i}": one(kind) for i, kind in enumerate(cfg.block_pattern)}
                   for _ in range(cfg.n_groups())],
        "tail": [one(kind) for kind in cfg.tail_kinds()],
    }
    if mem:
        out["memory"] = torch.empty((batch, mem, d), dtype=dtype, device="meta")
    return out


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
