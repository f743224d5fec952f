"""Core: the fused spectral pipeline compiler and the SAR system on it."""
from repro_torch.core.plan import (  # noqa: F401
    BACKEND_KERNEL,
    BACKEND_TORCH,
)
from repro_torch.core import sar  # noqa: F401
