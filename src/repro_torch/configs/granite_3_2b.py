"""granite-3-2b [dense] — GQA decoder.

Source: hf:ibm-granite/granite-3.0-2b-base:
40L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=49155.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    block_pattern=("attn",),
    rope_theta=10000.0,
    citation="hf:ibm-granite/granite-3.0-2b-base",
)


def config() -> Config:
    return Config(model=MODEL, optimizer=OptimizerConfig(name="vr_lamb", lr=2e-3, gamma=0.1, k=8))


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_momentum", lr=0.05, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
