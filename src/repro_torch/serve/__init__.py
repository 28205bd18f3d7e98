from repro_torch.serve.engine import GenerationConfig, ServeEngine  # noqa: F401
