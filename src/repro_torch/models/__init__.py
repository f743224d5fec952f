"""LM model stack for the assigned architecture pool (PyTorch)."""
from repro_torch.models.config import (  # noqa: F401
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)
from repro_torch.models.model import Model  # noqa: F401
from repro_torch.models.sharding import (  # noqa: F401
    DEFAULT_RULES,
    shard,
    use_mesh_rules,
)
