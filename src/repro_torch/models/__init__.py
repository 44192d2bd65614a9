from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    cache_shapes,
    decode_step,
    forward,
    init_params,
    prefill,
)
