"""minitron-4b [dense] — pruned nemotron. 32L d_model=3072 24H (GQA kv=8)
d_ff=9216 vocab=256000 [arXiv:2407.14679; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab_size=256_000,
        pattern=("global",),
    )
