from repro_torch.data.synthetic import MarkovLM, lm_batches  # noqa: F401
