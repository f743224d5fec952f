"""yi-34b [dense] — llama-arch GQA. 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000 [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64_000,
        pattern=("global",),
        rope_theta=5_000_000.0,
        tie_embeddings=False,
    )
