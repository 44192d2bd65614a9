"""internlm2-1.8b [dense] — GQA decoder.

Source: InternLM2 [arXiv:2403.17297]:
24L, d_model=2048, 16 heads (GQA kv=8), d_ff=8192, vocab=92544.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    block_pattern=("attn",),
    rope_theta=1e6,
    citation="arXiv:2403.17297",
)


def config() -> Config:
    return Config(model=MODEL, optimizer=OptimizerConfig(name="vr_lamb", lr=2e-3, gamma=0.1, k=8))


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_sgd", lr=0.05, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
