"""The fused spectral op: host-side pieces, its plain PyTorch version and
the hand-written CUDA kernel.

fft4step.py     — filter modes, precision policy, factorization, DFT
                  constants, bs16 codec, the plain four-step version.
ops.py          — public wrappers (padding, filter plumbing, batch sugar):
                  the CUDA kernel on CUDA tensors, the plain version on CPU.
ref.py          — torch.fft oracles.
_build.py       — nvcc build of csrc/*.cu, loaded with ctypes.
csrc/spectral.cu— the kernel (sm_90a).
"""
from repro_torch.kernels.fft4step import (  # noqa: F401
    FILTER_FULL,
    FILTER_NONE,
    FILTER_OUTER,
    FILTER_SHARED,
    FILTER_SHARED_OUTER,
    PRECISIONS,
    Precision,
    SpectralSpec,
    default_factorization,
    dft_constants,
    resolve_precision,
)
from repro_torch.kernels import ops, ref  # noqa: F401
