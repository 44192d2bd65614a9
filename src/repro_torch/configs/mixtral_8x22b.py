"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

Source: Mixtral of Experts [arXiv:2401.04088] scaled per assignment:
56L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.configs.base import Config, ModelConfig, MoEConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("swa",),
    sliding_window=4096,  # mixtral SWA window [arXiv:2310.06825 sec 2]
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    citation="arXiv:2401.04088",
)


def config() -> Config:
    return Config(model=MODEL, optimizer=OptimizerConfig(name="vr_lamb", lr=2e-3, gamma=0.1, k=8))


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_lamb", lr=1e-3, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
