"""whisper-small [audio] — encoder-decoder transformer backbone.

Source: Whisper [arXiv:2212.04356] per assignment:
12L decoder, d_model=768, 12 heads (kv=12), d_ff=3072, vocab=51865; 12L encoder.
The mel-spectrogram + conv frontend is a stub: the batch's "frames" entry
carries frame embeddings (B, 1500, d_model) drawn from the seed.
Positional encoding deviation: RoPE is used uniformly in this framework in
place of whisper's learned/sinusoidal absolute positions (backbone-equivalent).
"""
from repro_torch.configs.base import (Config, EncoderConfig, ModelConfig, OptimizerConfig,
                                      smoke_variant)

MODEL = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=("xattn",),  # every decoder layer cross-attends to encoder memory
    act="gelu",
    norm="layernorm",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    citation="arXiv:2212.04356",
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
