from repro_torch.models.transformer import (  # noqa: F401
    Transformer,
    cache_shapes,
    decode_step,
    decode_step_grid,
    forward,
    init_params,
    prefill,
    prefill_grid,
)
