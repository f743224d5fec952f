"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab_size=262_144,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=1024,
        act="gelu",
    )
