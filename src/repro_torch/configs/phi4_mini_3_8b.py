"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA.

Source: Phi-4 technical report [arXiv:2412.08905] per assignment:
32L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    block_pattern=("attn",),
    rope_theta=250000.0,
    citation="arXiv:2412.08905",
)


def config() -> Config:
    return Config(model=MODEL, optimizer=OptimizerConfig(name="vr_lamb", lr=2e-3, gamma=0.1, k=8))


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_adam", lr=1e-3, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
