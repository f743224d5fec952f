from repro_torch.data.pipeline import DataConfig, TokenStream  # noqa: F401
