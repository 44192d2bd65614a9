"""xlstm-1.3b [ssm] — mLSTM + sLSTM blocks at 7:1.

Source: xLSTM [arXiv:2405.04517] per assignment:
48L, d_model=2048, 4 heads (kv=4), d_ff=0 (no separate FFN; blocks carry their
own up/down projections), vocab=50304.
Constant-size recurrent state -> runs long_500k decode.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    qk_dim_factor=0.5,
    v_dim_factor=1.0,
    citation="arXiv:2405.04517",
)


def config() -> Config:
    return Config(model=MODEL, optimizer=OptimizerConfig(name="vr_adam", lr=1e-3, gamma=0.1, k=8))


def smoke() -> Config:
    return Config(
        model=smoke_variant(MODEL),
        optimizer=OptimizerConfig(name="vr_adam", lr=1e-3, k=4, warmup_steps=2, total_steps=8),
        global_batch=8,
        seq_len=32,
    )
