"""recurrentgemma-9b [hybrid] — RG-LRU recurrent blocks + local attention, 2:1.

Source: Griffin/RecurrentGemma [arXiv:2402.19427] per assignment:
38L, d_model=4096, 16 heads (MQA kv=1), d_ff=12288, vocab=256000.
Pattern: (rec, rec, local) — two RG-LRU blocks per local-attention block,
local window 2048 as in the paper. Sub-quadratic: runs long_500k decode.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local"),
    sliding_window=2048,
    act="gelu",  # geglu in the paper; gelu-gated here
    citation="arXiv:2402.19427",
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
