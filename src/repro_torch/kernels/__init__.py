"""The fused spectral op and the megakernel: host-side pieces, their plain
PyTorch versions and the hand-written CUDA kernels.

fft4step.py     — filter modes, precision policy, factorization, DFT
                  constants, bs16 codec, the plain four-step version; the
                  megakernel's MegaSpec and its plain version mega_plain.
ops.py          — public wrappers (padding, filter plumbing, batch sugar,
                  the residency cut): the CUDA kernels on CUDA tensors,
                  the plain versions on CPU.
transpose.py    — the tiled corner turn (the ``fused`` variant's): the CUDA
                  kernel on CUDA tensors, the plain version on CPU.
ref.py          — torch.fft oracles.
_build.py       — nvcc build of csrc/*.cu, loaded with ctypes.
csrc/spectral.cu        — the per-axis kernel (sm_90a).
csrc/mega.cu            — mega_resident and mega_staged (sm_90a).
csrc/spectral_common.cuh— the device code both share (four-step stages,
                          the Stockham pass, filter, tile pass).
csrc/long_lines.cuh     — lines past one block: the four-step over device
                          memory in one cooperative launch (both share it).
csrc/transpose.cu       — the tiled transpose (sm_90a).
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
from repro_torch.kernels import ops, ref, transpose  # noqa: F401
