from repro_torch.serve.engine import (  # noqa: F401
    ContinuousEngine,
    Engine,
    GenerationResult,
    RequestResult,
)
