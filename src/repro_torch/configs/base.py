"""Config dataclasses of the PyTorch port.

A copy of the parts of ``repro/configs/base.py`` that the port runs: the
model (with its MoE and encoder parts), optimizer and runtime configs and
``smoke_variant``.  The port keeps its own copy because the reference
module imports the JAX execution plan.

Block kinds the port's transformer runs (every kind of the reference):

  "attn"    full (causal) self-attention + MLP
  "swa"     sliding-window self-attention + MLP
  "local"   sliding-window self-attention + MLP (recurrentgemma naming)
  "xattn"   self-attention + cross-attention (to image/audio memory) + MLP
  "rec"     RG-LRU recurrent block + MLP                     [arXiv:2402.19427]
  "mlstm"   mLSTM block (matrix memory, chunkwise parallel)  [arXiv:2405.04517]
  "slstm"   sLSTM block (scalar memory, sequential scan)     [arXiv:2405.04517]

With ``moe`` set, the MLP of the attn/swa/local/xattn/rec blocks is a
mixture of experts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.backend import Backend

BLOCK_KINDS = ("attn", "swa", "local", "xattn", "rec", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    n_shared_experts: int = 0  # llama4-style always-on shared expert


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower of an encoder-decoder model (whisper).  Its frontend is
    a stub: the batch carries frame embeddings of shape (B, n_frames, d)."""

    n_layers: int = 12
    n_frames: int = 1500  # whisper-small: 30 s of audio -> 1500 frames after the conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0  # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 0  # 0 -> full attention for "attn"; "swa"/"local" need >0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_image_tokens: int = 0  # vlm: length of the stubbed vision-encoder output
    causal: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # xLSTM specifics
    qk_dim_factor: float = 0.5
    v_dim_factor: float = 1.0
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_layers(self) -> Tuple[str, ...]:
        """The full per-layer kind list, pattern repeated/truncated to n_layers."""
        p = self.block_pattern
        reps = math.ceil(self.n_layers / len(p))
        return tuple((p * reps)[: self.n_layers])

    def n_groups(self) -> int:
        """Number of full pattern groups; the remainder is the tail."""
        return self.n_layers // len(self.block_pattern)

    def tail_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_pattern[: self.n_layers % len(self.block_pattern)])

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula (the rec/mlstm/slstm terms are its estimates)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d  # wq wk wv wo
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        total = 0
        for kind in self.pattern_layers():
            if kind in ("attn", "swa", "local"):
                body = attn + self._mlp_or_moe(mlp)
            elif kind == "xattn":
                body = 2 * attn + self._mlp_or_moe(mlp)
            elif kind == "rec":
                body = 2 * d * d + 2 * d * d // 8 + 3 * d + self._mlp_or_moe(mlp)
            elif kind == "mlstm":
                qk = int(d * self.qk_dim_factor)
                vd = int(d * self.v_dim_factor)
                body = d * (2 * qk + 3 * vd) + vd * d + 2 * d * 2 * d
            elif kind == "slstm":
                body = 4 * d * d + 2 * d * 4 * d
            else:
                raise ValueError(kind)
            total += body + 2 * d  # norms
        total += v * d
        if not self.tie_embeddings:
            total += v * d
        if self.encoder is not None:
            total += self.encoder.n_layers * (attn + mlp + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Parameters one token reads (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        mlp = 3 * self.d_model * self.d_ff if self.act == "swiglu" else 2 * self.d_model * self.d_ff
        n_moe = sum(1 for k in self.pattern_layers() if k in ("attn", "swa", "local", "xattn"))
        return self.param_count() - n_moe * mlp * (m.n_experts - m.top_k)

    def _mlp_or_moe(self, mlp: int) -> int:
        if self.moe is None:
            return mlp
        m = self.moe
        return mlp * (m.n_experts + m.n_shared_experts) + self.d_model * m.n_experts


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "vr_lamb"  # {sgd,momentum,adam,lars,lamb} or vr_ prefixed
    lr: float = 1e-3
    warmup_steps: int = 0  # 0 = no warm-up (explicit opt-in)
    total_steps: int = 1000
    schedule: str = "cosine"  # cosine | poly | linear | constant
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    b3: float = 0.9  # GSNR momentum decay (paper beta_3)
    eps: float = 1e-6
    momentum: float = 0.9
    grad_clip: float = 1.0
    # --- VRGD hyper-parameters (paper defaults) ---
    gamma: float = 0.1  # GSNR clip floor, paper sec. 4.1 (never tuned in paper)
    k: int = 8  # statistic groups; paper: min devices holding LB, >= 8
    gsnr_source: str = "microbatch"  # microbatch | data_axis
    gsnr_eps: float = 1e-12
    stats_method: str = "scan"  # scan (paper) | vmap (shared FSDP gathers)
    gsnr_refresh: int = 1  # recompute GradStats every R steps (1 = paper)
    state_dtype: str = "float32"  # storage dtype for m/v/p moments (math in f32)
    # --- batch-size LR scaling (paper sec. 6) ---
    base_batch: int = 0  # reference batch cfg.lr was tuned at; 0 = no rescale
    lr_scale_rule: str = "sqrt"  # sqrt (paper's choice) | linear | none
    noise_beta: float = 0.9  # EMA decay for tr(Sigma)/|G|^2 noise-scale smoothing

    @property
    def is_vr(self) -> bool:
        return self.name.startswith("vr_")


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    # mesh axis names and the FSDP switch of the weights' sharding rules
    # (sharding/rules.py), used under a launch/mesh.py::GridMesh
    dp_axis: str = "data"
    tp_axis: str = "model"
    pod_axis: str = "pod"
    fsdp: bool = True  # shard params/opt-state over the data axis too
    remat: bool = True  # recompute each layer group's forward in the backward
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Execution plan (repro_torch.backend.Backend): which implementation
    # serves attention, the optimizer update and the gradient statistics.
    backend: Backend = Backend()
    attn_chunk: int = 1024  # q-chunk for online-softmax attention (0 = naive)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    parallel: ParallelismConfig = dataclasses.field(default_factory=ParallelismConfig)
    seed: int = 0
    global_batch: int = 32
    seq_len: int = 512  # serving default: cache_len = seq_len + 64, prefill chunk = seq_len
    # Cross-entropy normalization for packed batches: "token" = mean over
    # live tokens; "document" = every packed document contributes its own
    # token-mean NLL with equal weight.  Ignored for unpacked batches.
    loss_norm: str = "token"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant: <=2 pattern groups, d_model<=256, <=4
    experts, a 2-layer encoder over 16 frames, <=16 image tokens."""
    pattern = cfg.block_pattern
    if len(pattern) > 4:
        seen, small = set(), []
        for k in pattern:
            if k not in seen:
                seen.add(k)
                small.append(k)
        pattern = tuple(small)
    n_layers = len(pattern) if len(pattern) >= 2 else 2
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=min(4, cfg.moe.n_experts))
    enc = None
    if cfg.encoder is not None:
        enc = dataclasses.replace(cfg.encoder, n_layers=2, n_frames=16)
    kw = dict(
        n_layers=n_layers,
        d_model=min(cfg.d_model, 256),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=0,
        block_pattern=pattern,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        moe=moe,
        encoder=enc,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        name=cfg.name + "-smoke",
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
