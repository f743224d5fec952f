"""FFTConvMixer — the paper's fused spectral kernel inside an LM block.

A Hyena/S4-style long-convolution mixer: each channel is convolved with a
learned length-S causal kernel, computed as FFT -> pointwise spectral
multiply -> IFFT in ONE launch of the spectral kernel
(``ops.spectral_op``, filter mode ``full``: each line's filter is its
channel's spectrum). None of the assigned architectures is LTI, so this
is the layer that shows the paper's dataflow per channel inside an LM.

The learned kernel is parameterized in the time domain with exponential
decay (S4D-style), zero-padded to 2S for causal (linear, not circular)
convolution; its spectrum is ``torch.fft.fft`` of it on every call (one
(D, 2S) transform beside the (B*D, 2S) lines of the data).

The backward of the fused launch is the vector-Jacobian product of the
``torch.fft`` oracle (``_conv_lines_oracle``), as in the reference: there
is no backward kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamModule, truncated_normal
from repro_torch.models.sharding import shard

BACKENDS = ("kernel", "plain")


class FFTConvMixer(ParamModule):
    """The mixer's weights (``init_fftconv``'s names); ``forward(x)`` is
    ``fftconv_forward``."""

    def __init__(self, d: int, max_len: int, device=None):
        super().__init__(device)
        self.param("in_proj", (d, d))
        self.param("gate_proj", (d, d))
        self.param("kernel", (d, max_len))
        self.param("decay", (d,))
        self.param("out_proj", (d, d))

    def reset_parameters(self, generator: torch.Generator):
        d, max_len = self.kernel.shape
        self._fill("in_proj", truncated_normal(generator, (d, d), d ** -0.5))
        self._fill("gate_proj", truncated_normal(generator, (d, d),
                                                 d ** -0.5))
        self._fill("kernel", truncated_normal(generator, (d, max_len), 0.02))
        # per-channel log decay rate
        self._fill("decay", torch.linspace(1.0, 6.0, d))
        self._fill("out_proj", truncated_normal(generator, (d, d), d ** -0.5))

    def forward(self, x):
        return fftconv_forward(self, x)


def init_fftconv(generator: torch.Generator, d: int,
                 max_len: int) -> FFTConvMixer:
    m = FFTConvMixer(d, max_len, generator.device)
    m.reset_parameters(generator)
    return m


def _conv_lines_oracle(lines, hr, hi):
    """real(IFFT(FFT(lines) * H)) — the unfused torch.fft path (also the
    VJP)."""
    h = torch.complex(hr, hi)
    return torch.fft.ifft(torch.fft.fft(lines, dim=1) * h, dim=1).real.to(
        torch.float32)


def _conv_lines_launch(lines, hr, hi, plain: bool = False):
    """FFT -> per-line filter -> IFFT through the spectral op: ONE launch
    of the CUDA kernel on a CUDA tensor (the plain version on a CPU
    tensor, or anywhere with ``plain``)."""
    op = ops.spectral_op_plain if plain else ops.spectral_op
    yr, _ = op(lines, torch.zeros_like(lines), hr=hr, hi=hi, fwd=True,
               inv=True, axis=1, filter_mode="full", block=8)
    return yr


class _ConvLinesFused(torch.autograd.Function):
    """The fused launch forward, the oracle's VJP backward."""

    @staticmethod
    def forward(ctx, lines, hr, hi, plain):
        ctx.save_for_backward(lines, hr, hi)
        return _conv_lines_launch(lines, hr, hi, plain)

    @staticmethod
    def backward(ctx, g):
        lines, hr, hi = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (lines, hr, hi)]
            y = _conv_lines_oracle(*inputs)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def _conv_lines_fused(lines, hr, hi, plain: bool = False):
    """ONE fused launch: FFT -> per-line filter -> IFFT, differentiable
    (the backward is the oracle's VJP)."""
    return _ConvLinesFused.apply(lines, hr, hi, plain)


def mixer_lines(p, x):
    """The launch's inputs of ``fftconv_forward``: (lines, hr, hi, gate).

    lines: (B*D, 2S) real signals, channel-major and zero-padded, so each
    line's filter is its channel's causal kernel spectrum (hr, hi), tiled
    over the batch (FILTER_FULL per line); gate: silu(x @ gate_proj)."""
    b, s, d = x.shape
    dt = x.dtype
    u = x @ p["in_proj"].to(dt)
    gate = F.silu(x @ p["gate_proj"].to(dt))

    # causal kernel, decayed, zero-padded to 2S -> spectrum (2S,) per channel
    t = torch.arange(s, dtype=torch.float32, device=x.device)
    kern = p["kernel"][:, :s] * torch.exp(-torch.exp(p["decay"])[:, None]
                                          * t / s)               # (D, S)
    kf_full = torch.fft.fft(F.pad(kern, (0, s)), dim=1)

    lines = u.permute(0, 2, 1).reshape(b * d, s)
    lines = F.pad(lines, (0, s)).to(torch.float32).contiguous()
    hr = kf_full.real.to(torch.float32).repeat(b, 1)
    hi = kf_full.imag.to(torch.float32).repeat(b, 1)
    return lines, hr, hi, gate


def fftconv_forward(p, x, backend: str = "kernel"):
    """x: (B, S, D) float32 -> (B, S, D). The whole (B*D, 2S) batch of
    lines in one spectral launch (``backend="kernel"``); ``"plain"`` runs
    that op's plain version on any device (the yardstick on the card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    b, s, d = x.shape
    lines, hr, hi, gate = mixer_lines(p, x)
    yr = _conv_lines_fused(lines, hr, hi, backend == "plain")
    y = yr[:, :s].reshape(b, d, s).permute(0, 2, 1).to(x.dtype)
    y = shard(y, "batch", None, None)
    return (y * gate) @ p["out_proj"].to(x.dtype)


def fftconv_reference(p, x):
    """Oracle: per-channel causal convolution via torch.fft (unfused)."""
    b, s, d = x.shape
    u = x @ p["in_proj"]
    gate = F.silu(x @ p["gate_proj"])
    t = torch.arange(s, dtype=torch.float32, device=x.device)
    kern = p["kernel"][:, :s] * torch.exp(-torch.exp(p["decay"])[:, None]
                                          * t / s)
    uf = torch.fft.fft(F.pad(u.permute(0, 2, 1), (0, s)), dim=2)
    kf = torch.fft.fft(F.pad(kern, (0, s)), dim=1)
    y = torch.fft.ifft(uf * kf[None], dim=2).real[:, :, :s]
    y = y.permute(0, 2, 1)
    return (y * gate) @ p["out_proj"]
