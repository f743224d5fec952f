"""``torch.fft`` oracles for the fused spectral op (complex64).

The numerical ground truth the plain version and the CUDA kernel are
tested against, and the ``torch`` backend's arithmetic. The port's main
path never calls these: a spectral op on a CUDA tensor runs the
hand-written kernel.
"""
from __future__ import annotations

import torch


def to_complex(xr, xi):
    return torch.complex(torch.as_tensor(xr, dtype=torch.float32),
                         torch.as_tensor(xi, dtype=torch.float32))


def from_complex(x):
    return (x.real.to(torch.float32).contiguous(),
            x.imag.to(torch.float32).contiguous())


def fft_ref(xr, xi, axis: int):
    return from_complex(torch.fft.fft(to_complex(xr, xi), dim=axis))


def ifft_ref(xr, xi, axis: int):
    return from_complex(torch.fft.ifft(to_complex(xr, xi), dim=axis))


def spectral_ref(xr, xi, *, axis: int, fwd: bool, inv: bool,
                 hr=None, hi=None, u=None, v=None):
    """Oracle for the fused op: [FFT] -> [pointwise filter] -> [IFFT].

    hr/hi: explicit filter (broadcastable to x). u/v: rank-K phase
    exp(i * sum_k u[line,k] v[sample,k]) (u: (lines,) or (lines, K);
    v: (n,) or (n, K)). For a batch pass axis=-1/-2."""
    x = to_complex(xr, xi)
    if fwd:
        x = torch.fft.fft(x, dim=axis)
    if hr is not None:
        x = x * to_complex(hr, hi)
    if u is not None:
        u = torch.as_tensor(u, dtype=torch.float32)
        v = torch.as_tensor(v, dtype=torch.float32)
        u2 = u.reshape(u.shape[0], -1)
        v2 = v.reshape(v.shape[0], -1)
        phase = torch.einsum("lk,sk->ls", u2, v2)   # (lines, samples)
        if axis in (0, -2):
            phase = phase.T
        x = x * torch.polar(torch.ones_like(phase), phase)
    if inv:
        x = torch.fft.ifft(x, dim=axis)
    return from_complex(x)


def transpose_ref(x):
    """Oracle of the tiled transpose: the last two axes swapped."""
    return torch.as_tensor(x).transpose(-2, -1)
