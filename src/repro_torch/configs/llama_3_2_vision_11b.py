"""llama-3.2-vision-11b [vlm] — decoder LM with cross-attention image layers.

Source: hf:meta-llama/Llama-3.2-11B-Vision per assignment:
40L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256.
Cross-attn layers interleaved every 5th layer; the ViT vision encoder is a
stub: the batch's "image" entry carries patch embeddings (B, 1601, d_model)
drawn from the seed, where 1601 = 1 CLS + 40x40 patches.
"""
from repro_torch.configs.base import Config, ModelConfig, OptimizerConfig, smoke_variant

MODEL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500000.0,
    n_image_tokens=1601,
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
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
