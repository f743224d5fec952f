"""granite-moe-3b-a800m [moe] — 40 experts top-8. 32L d_model=1536 24H
(GQA kv=8) d_ff=512 (per expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49_155,
        pattern=("global",),
        ffn="moe",
        # group_size 256: top-8 of 40 puts dispatch bytes at
        # tokens * group * k * cf — 4x smaller groups keep it ~10 GB global
        moe=MoEConfig(n_experts=40, top_k=8, group_size=256),
    )
