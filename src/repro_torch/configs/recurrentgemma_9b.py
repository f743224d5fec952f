"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent
pattern. 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]."""
from repro_torch.models.config import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256_000,
        pattern=("rglru", "rglru", "local"),
        window=2048,
        rglru=RGLRUConfig(conv_width=4, lru_width=4096),
        act="gelu",
    )
