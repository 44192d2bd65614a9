"""granite-20b [dense] — llama-arch code model with MQA (kv=1).

Source: Granite Code Models [arXiv:2405.04324] per assignment:
52L, d_model=6144, 48 heads (MQA kv=1), d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # multi-query attention
    d_ff=24576,
    vocab_size=49152,
    block_pattern=("attn",),
    act="gelu",  # granite-20b-code uses gelu MLP
    citation="arXiv:2405.04324",
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
