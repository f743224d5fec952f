"""SpectralPipeline — the paper's contribution as a composable PyTorch op.

One fused launch computing  [FFT] -> pointwise filter -> [IFFT]  along rows
or columns of a 2-D block, with the intermediate spectrum never leaving
on-chip memory. Backend ``kernel`` runs ``ops.spectral_op``: one launch of
the hand-written CUDA kernel (``kernels/csrc/spectral.cu``) on a CUDA
tensor, its plain PyTorch version on a CPU tensor. Backend ``torch`` is
the unfused oracle (``torch.fft`` per stage, ``kernels/ref.py``).

Also exposes ``fft_conv``, a fused long-convolution primitive (FFT * K *
IFFT in one launch) — the building block of the FFTConvMixer LM layer
(``models/fftconv.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.plan import BACKEND_KERNEL, BACKEND_TORCH
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fft4step import (FILTER_NONE, FILTER_SHARED,
                                          FILTER_SHARED_OUTER)

BACKENDS = (BACKEND_KERNEL, BACKEND_TORCH)
SHARED_MODES = (FILTER_SHARED, FILTER_SHARED_OUTER)   # an (n,) vector filter


@dataclasses.dataclass(frozen=True)
class SpectralPipeline:
    """A reusable fused [FFT] * H * [IFFT] stage.

    axis: 1 = transform rows of (lines, n); 0 = columns of (n, lines).
    filter_mode: one of kernels.FILTER_* ('none'|'shared'|'full'|'outer'|
                 'shared_outer').
    backend: 'kernel' (one fused launch) or 'torch' (unfused torch.fft).
    precision: an ``fft4step.PRECISIONS`` policy name; ``compute_dtype`` is
    its deprecated alias. There is no interpret mode: a CUDA tensor runs
    the CUDA kernel (or raises), a CPU tensor its plain version.
    """

    fwd: bool = True
    inv: bool = True
    filter_mode: str = FILTER_NONE
    axis: int = 1
    backend: str = BACKEND_KERNEL
    block: int = 8
    fft_impl: str = "matmul"
    precision: Optional[str] = None
    compute_dtype: Optional[str] = None  # deprecated alias for `precision`
    karatsuba: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")

    def __call__(self, xr, xi, hr=None, hi=None, u=None, v=None):
        if self.backend == BACKEND_TORCH:
            h = dict(hr=hr, hi=hi) if hr is not None else {}
            o = dict(u=u, v=v) if u is not None else {}
            if self.filter_mode in SHARED_MODES and hr is not None:
                # broadcast the shared vector along the line axis (the
                # reference does it for 'shared' alone, so its oracle
                # refuses 'shared_outer' on columns)
                shape = (1, -1) if self.axis == 1 else (-1, 1)
                h = dict(hr=hr.reshape(shape), hi=hi.reshape(shape))
            return ref.spectral_ref(xr, xi, axis=self.axis, fwd=self.fwd,
                                    inv=self.inv, **h, **o)
        return ops.spectral_op(
            xr, xi, hr=hr, hi=hi, u=u, v=v, axis=self.axis, fwd=self.fwd,
            inv=self.inv, filter_mode=self.filter_mode, block=self.block,
            fft_impl=self.fft_impl, karatsuba=self.karatsuba,
            precision=self.precision or self.compute_dtype)


def fft_conv(x: torch.Tensor, k_fft_r: torch.Tensor, k_fft_i: torch.Tensor,
             backend: str = BACKEND_KERNEL, block: int = 8) -> torch.Tensor:
    """Fused circular convolution: real input (B, N), precomputed filter
    spectrum (N,) split re/im -> real output (B, N). ONE launch.

    Callers wanting causal/linear convolution zero-pad x and the kernel to
    2N before calling (standard FFT-conv practice)."""
    pipe = SpectralPipeline(fwd=True, inv=True, filter_mode=FILTER_SHARED,
                            backend=backend, block=block)
    yr, _ = pipe(x, torch.zeros_like(x), hr=k_fft_r, hi=k_fft_i)
    return yr
