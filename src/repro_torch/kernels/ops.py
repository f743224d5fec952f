"""Public wrappers around the fused spectral op.

All functions take and return split re/im float32 tensors. Each wrapper
accepts one scene — (lines, N) rows layout / (N, lines) cols layout — or
a batch with a leading batch dim, (B, lines, N) / (B, N, lines), run as
ONE launch; 2-D inputs are treated as B=1 and squeezed on return. Filter
arguments are unbatched (scenes share the SceneConfig filters).

Where it runs is decided by the tensors alone:

* a CUDA tensor launches the hand-written kernel ``csrc/spectral.cu``
  (one launch per call, counted in ``SPECTRAL_LAUNCHES``), or raises —
  there is no fallback;
* a CPU tensor runs the plain PyTorch version
  (``fft4step.spectral_plain``).

``spectral_op_plain`` runs the plain version on any device; it is the
yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.fft4step import (
    FILTER_FULL,
    FILTER_MODES,
    FILTER_NONE,
    FILTER_OUTER,
    FILTER_SHARED,
    FILTER_SHARED_OUTER,
    SpectralSpec,
    device_constants,
    resolve_precision,
    spectral_plain,
)

# Launches of the CUDA spectral kernel in this process (one per call on a
# CUDA tensor, counted where the launch succeeds and nowhere else).
SPECTRAL_LAUNCHES = 0

KERNEL_NAME = "spectral"
KERNEL_MAX_N = 4096
_MODE_CODES = {m: i for i, m in enumerate(FILTER_MODES)}
_ROADMAP = "ROADMAP.md Queue 2, item 1"


def _pad_lines(x, axis, mult):
    lines = x.shape[axis]
    pad = (-lines) % mult
    if pad == 0:
        return x, lines
    widths = [0, 0] * x.ndim
    # F.pad lists (before, after) pairs from the LAST dim backwards
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths), lines


def _prepare(xr, xi, hr, hi, u, v, *, axis, fwd, inv, filter_mode, block,
             fft_impl, karatsuba, precision, n1, n2, n3):
    """Batch, pad and lay out one call: (spec, xr, xi, filter_args,
    lines, batched) with filters in the per-axis kernel layouts."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    precision = resolve_precision(precision).name
    batched = xr.ndim == 3
    if not batched:
        xr = xr[None]
        xi = xi[None]
    line_axis = 1 if axis == 1 else 2
    n = xr.shape[axis + 1]
    xr, lines = _pad_lines(xr, line_axis, block)
    xi, _ = _pad_lines(xi, line_axis, block)

    outer_rank = 1
    if filter_mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        u = u.reshape(u.shape[0], -1)
        v = v.reshape(v.shape[0], -1)
        outer_rank = u.shape[1]

    spec = SpectralSpec(
        n=n, fwd=fwd, inv=inv, filter_mode=filter_mode, axis=axis,
        fft_impl=fft_impl, karatsuba=karatsuba,
        precision=precision, n1=n1, n2=n2, n3=n3, outer_rank=outer_rank)

    filt_line_axis = 0 if axis == 1 else 1   # filters stay 2-D
    fshape = (1, n) if axis == 1 else (n, 1)
    filter_args = []
    if filter_mode == FILTER_SHARED:
        filter_args = [hr.reshape(fshape), hi.reshape(fshape)]
    elif filter_mode == FILTER_FULL:
        hr, _ = _pad_lines(hr, filt_line_axis, block)
        hi, _ = _pad_lines(hi, filt_line_axis, block)
        filter_args = [hr, hi]
    elif filter_mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        u, _ = _pad_lines(u, 0, block)          # (lines_padded, K)
        filter_args = [u, v.T] if axis == 1 else [u.T, v]
        if filter_mode == FILTER_SHARED_OUTER:
            filter_args = [hr.reshape(fshape), hi.reshape(fshape)] \
                + filter_args
    return spec, xr, xi, filter_args, lines, batched


def _finish(yr, yi, axis, lines, batched):
    if axis == 1:
        yr, yi = yr[:, :lines], yi[:, :lines]
    else:
        yr, yi = yr[:, :, :lines], yi[:, :, :lines]
    if not batched:
        return yr[0], yi[0]
    return yr, yi


# ---------------------------------------------------------------------------
# The CUDA launch
# ---------------------------------------------------------------------------

def _bind():
    lib = _build.load(KERNEL_NAME)
    fn = lib.spectral_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 4 + [i] * 9 + [p] * 10 + [i] + [ll] * 4
                       + [i, i, p])
        fn.restype = ctypes.c_int
        lib.spectral_error_string.argtypes = [ctypes.c_int]
        lib.spectral_error_string.restype = ctypes.c_char_p
    return lib


def kernel_tile(n: int, axis: int) -> tuple[int, int]:
    """(lines per CTA, threads per CTA) of the spectral kernel: rows hold
    4096/N whole lines (one 32 KiB line at N=4096), cols at least 4
    adjacent columns so strided loads come in 16-byte runs; every thread
    stages 16 outputs of each stage."""
    tile = max(1 if axis == 1 else 4, 4096 // n)
    return tile, tile * n // 16


def check_kernel_spec(spec: SpectralSpec) -> tuple[int, int]:
    """Raise ValueError for what the CUDA kernel does not take yet;
    returns its two-factor split (n1, n2)."""
    if spec.precision != "f32":
        raise ValueError(
            f"precision {spec.precision!r} is not taken by the CUDA "
            f"spectral kernel yet (bf16/f16/bs16: {_ROADMAP}b)")
    if spec.karatsuba:
        raise ValueError("karatsuba=True is not taken by the CUDA "
                         f"spectral kernel yet ({_ROADMAP}c)")
    if spec.fft_impl != "matmul":
        raise ValueError(f"fft_impl={spec.fft_impl!r} is not taken by the "
                         "CUDA spectral kernel yet (ROADMAP.md Queue 2, "
                         "item 4)")
    if spec.n > KERNEL_MAX_N:
        raise ValueError(
            f"n={spec.n} > {KERNEL_MAX_N} is not taken by the CUDA spectral "
            f"kernel yet ({_ROADMAP}d)")
    factors = spec.factors()
    if len(factors) != 2:
        raise ValueError(
            f"the CUDA spectral kernel takes a two-factor split, got "
            f"{factors} ({_ROADMAP}d)")
    return factors


def _launch_cuda(spec: SpectralSpec, xr, xi, filter_args):
    global SPECTRAL_LAUNCHES
    n1, n2 = check_kernel_spec(spec)
    tensors = [xr, xi, *filter_args]
    dev = xr.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA spectral kernel takes float32, "
                             f"got {t.dtype}")
    xr = xr.contiguous()
    xi = xi.contiguous()
    b = xr.shape[0]
    n = spec.n
    lines = xr.shape[2] if spec.axis == 0 else xr.shape[1]
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if yr.numel() == 0:
        return yr, yi
    consts = device_constants((n1, n2), str(dev))
    hr = hi = u = v = None
    u_line = u_k = v_n = v_k = 0
    rank = spec.outer_rank
    mode = spec.filter_mode
    if mode in (FILTER_SHARED, FILTER_FULL, FILTER_SHARED_OUTER):
        hr = filter_args[0].contiguous()
        hi = filter_args[1].contiguous()
    if mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        u, v = filter_args[-2], filter_args[-1]
        if spec.axis == 1:   # u (L, K), v (K, N)
            u_line, u_k = u.stride(0), u.stride(1)
            v_n, v_k = v.stride(1), v.stride(0)
        else:                # u (K, L), v (N, K)
            u_line, u_k = u.stride(1), u.stride(0)
            v_n, v_k = v.stride(0), v.stride(1)
    tile, threads = kernel_tile(n, spec.axis)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spectral_launch(
            ptr(xr), ptr(xi), ptr(yr), ptr(yi),
            b, lines, n, n1, n2, spec.axis, int(spec.fwd), int(spec.inv),
            _MODE_CODES[mode], *(ptr(c) for c in consts),
            ptr(hr), ptr(hi), ptr(u), ptr(v), rank,
            u_line, u_k, v_n, v_k, tile, threads, stream)
    if err != 0:
        msg = lib.spectral_error_string(err).decode()
        raise RuntimeError(f"spectral kernel launch failed ({err}): {msg}")
    SPECTRAL_LAUNCHES += 1
    return yr, yi


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _spectral(xr, xi, hr, hi, u, v, plain: bool, *, axis: int = 1,
              fwd: bool = True, inv: bool = True,
              filter_mode: str = FILTER_NONE, block: int = 8,
              fft_impl: str = "matmul", karatsuba: bool = False,
              precision: Optional[str] = None, n1: Optional[int] = None,
              n2: Optional[int] = None, n3: Optional[int] = None):
    spec, xr, xi, filter_args, lines, batched = _prepare(
        xr, xi, hr, hi, u, v, axis=axis, fwd=fwd, inv=inv,
        filter_mode=filter_mode, block=block, fft_impl=fft_impl,
        karatsuba=karatsuba, precision=precision, n1=n1, n2=n2, n3=n3)
    if plain or xr.device.type == "cpu":
        yr, yi = spectral_plain(spec, xr, xi, *filter_args)
    elif xr.device.type == "cuda":
        yr, yi = _launch_cuda(spec, xr, xi, filter_args)
    else:
        raise ValueError(f"no spectral kernel for device {xr.device}")
    return _finish(yr, yi, axis, lines, batched)


def spectral_op(xr, xi, hr=None, hi=None, u=None, v=None, **kw):
    """One fused op: [FFT] -> [filter multiply] -> [IFFT] along `axis`.

    x: (lines, N) when axis=1, (N, lines) when axis=0, or a batch
    (B, lines, N) / (B, N, lines) in the same single launch.
    Filter args by mode (unbatched):
      shared:       hr/hi (N,)
      full:         hr/hi one scene's shape
      outer:        u (lines,) or (lines, K), v (N,) or (N, K) —
                    filter = exp(i * sum_k u[line,k] * v[sample,k])
      shared_outer: hr/hi and u/v (the shared vector first)
    Keywords: axis, fwd, inv, filter_mode, block (line padding granule),
    fft_impl, karatsuba, precision (f32 | bf16 | f16 | bs16), n1/n2/n3
    (factorization override). On a CUDA tensor this launches the CUDA
    kernel, which takes f32, karatsuba=False, matmul and N <= 4096 and
    raises ValueError for anything else; on a CPU tensor it runs the
    plain version, which takes all of them.
    """
    return _spectral(xr, xi, hr, hi, u, v, False, **kw)


def spectral_op_plain(xr, xi, hr=None, hi=None, u=None, v=None, **kw):
    """``spectral_op`` through the plain PyTorch version on any device."""
    return _spectral(xr, xi, hr, hi, u, v, True, **kw)


# ---- Convenience entry points (named for the SAR pipeline steps) ----------

def fft_rows(xr, xi, **kw):
    """Batched forward FFT along the last axis of (B, N)."""
    return spectral_op(xr, xi, fwd=True, inv=False, axis=1, **kw)


def ifft_rows(xr, xi, **kw):
    return spectral_op(xr, xi, fwd=False, inv=True, axis=1, **kw)


def fft_cols(xr, xi, **kw):
    """Forward FFT along axis 0 of (N, C) — transpose-free columns."""
    return spectral_op(xr, xi, fwd=True, inv=False, axis=0, **kw)


def ifft_cols(xr, xi, **kw):
    return spectral_op(xr, xi, fwd=False, inv=True, axis=0, **kw)


def fused_fft_mult_ifft_rows(xr, xi, hr, hi, **kw):
    """Range compression in one launch: FFT · H · IFFT per line."""
    return spectral_op(xr, xi, hr=hr, hi=hi, fwd=True, inv=True, axis=1,
                       filter_mode=FILTER_SHARED, **kw)


def fused_mult_ifft_cols(xr, xi, hr, hi, **kw):
    """Azimuth compression in one launch: H · IFFT per column, with the
    full 2-D azimuth filter H_a(f_a, R0)."""
    return spectral_op(xr, xi, hr=hr, hi=hi, fwd=False, inv=True, axis=0,
                       filter_mode=FILTER_FULL, **kw)


def fused_rcmc_rows(xr, xi, shift, freqs, **kw):
    """Exact RCMC in one launch per azimuth-frequency row: FFT ->
    exp(i * shift[row] * freqs[col]) -> IFFT (Fourier shift theorem)."""
    return spectral_op(xr, xi, u=shift, v=freqs, fwd=True, inv=True, axis=1,
                       filter_mode=FILTER_OUTER, **kw)


def fused_mult_ifft_cols_outer(xr, xi, u, v, **kw):
    """Azimuth compression with the on-the-fly phase H = exp(i u[col] v[row])."""
    return spectral_op(xr, xi, u=u, v=v, fwd=False, inv=True, axis=0,
                       filter_mode=FILTER_OUTER, **kw)


def fused_rc_rcmc_rows(xr, xi, hr, hi, u, v, **kw):
    """Range compression AND exact RCMC in one launch (data already in
    the azimuth-frequency domain): FFT -> H_r[col] * exp(i shift[row] *
    freqs[col]) -> IFFT."""
    return spectral_op(xr, xi, hr=hr, hi=hi, u=u, v=v, fwd=True, inv=True,
                       axis=1, filter_mode=FILTER_SHARED_OUTER, **kw)
