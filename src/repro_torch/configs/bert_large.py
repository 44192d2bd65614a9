"""bert-large — the paper's own primary benchmark architecture (Table 1/2).

BERT-large [arXiv:1810.04805]: 24L, d_model=1024, 16 heads, d_ff=4096,
vocab=30522, bidirectional encoder, GELU, LayerNorm.  The paper pretrains
it with VR-LAMB at batch sizes 16k..64k (two-phase seq 128/512; phase-1
hyper-parameters from paper Appendix Table 9, the 64k row).
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="bert-large",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    block_pattern=("attn",),
    act="gelu",
    norm="layernorm",
    causal=False,  # bidirectional encoder
    citation="arXiv:1810.04805 / paper Table 1",
)


def config() -> Config:
    # phase-1 VR-LAMB hyper-params from paper Appendix Table 9 (64k row)
    return Config(
        model=MODEL,
        optimizer=OptimizerConfig(
            name="vr_lamb", lr=0.007, warmup_steps=2000, total_steps=7820, gamma=0.1, k=8
        ),
        global_batch=64 * 1024,
        seq_len=128,
    )


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_lamb", lr=1e-3, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
