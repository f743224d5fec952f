"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion, iRoPE-style 3:1 chunked-local:global attention. 48L d_model=5120
40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        pattern=("local", "local", "local", "global"),
        window=8192,
        ffn="moe",
        moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True),
        rope_theta=500_000.0,
        tie_embeddings=False,
    )
