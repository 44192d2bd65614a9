from repro_torch.sharding.rules import Rules  # noqa: F401
