"""Config dataclasses of the PyTorch port.

A copy of the parts of ``repro/configs/base.py`` that the port runs: the
model, optimizer and runtime configs and ``smoke_variant``.  The port keeps
its own copy because the reference module imports the JAX execution plan.

Block kinds the port's transformer runs:

  "attn"    full (causal) self-attention + MLP
  "swa"     sliding-window self-attention + MLP
  "local"   sliding-window self-attention + MLP (recurrentgemma naming)

Cross-attention, MoE, recurrent and xLSTM blocks are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.backend import Backend

ATTN_KINDS = ("attn", "swa", "local")


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
    causal: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
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
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        total = 0
        for kind in self.pattern_layers():
            if kind not in ATTN_KINDS:
                raise ValueError(f"block kind {kind!r} is not ported")
            total += attn + mlp + 2 * d
        total += v * d
        if not self.tie_embeddings:
            total += v * d
        return total


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
    """Reduced same-family variant: <=2 pattern groups, d_model<=256."""
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
        name=cfg.name + "-smoke",
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
