"""Core: the fused spectral pipeline compiler, the fused op as a
composable PyTorch op, and the SAR system on it."""
from repro_torch.core.plan import (  # noqa: F401
    BACKEND_KERNEL,
    BACKEND_TORCH,
)
from repro_torch.core.fusion import SpectralPipeline, fft_conv  # noqa: F401
from repro_torch.core import sar  # noqa: F401
