"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with a shared expert,
early-fusion multimodal family (text backbone here).

Source: hf:meta-llama/Llama-4-Scout-17B-16E family card per assignment:
48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192, vocab=202048, MoE 128e top-1.
"""
from repro_torch.configs.base import Config, ModelConfig, MoEConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn",),
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25, n_shared_experts=1),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
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
