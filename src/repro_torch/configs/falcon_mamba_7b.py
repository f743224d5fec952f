"""falcon-mamba-7b [ssm] — Mamba-1, attention-free. 64L d_model=4096
ssm_state=16 vocab=65024 [arXiv:2410.05355; unverified]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        n_layers=64,
        d_model=4096,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=65_024,
        pattern=("mamba",),
        ffn="none",
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    )
