"""Public wrappers around the fused spectral op and the megakernel.

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

``mega_spectral_op`` runs a whole multi-axis chain of segments in ONE
launch of ``csrc/mega.cu`` (``mega_resident`` or ``mega_staged`` by
``residency``, counted per kernel in ``MEGA_LAUNCHES``) on a CUDA tensor, and
``fft4step.mega_plain`` on a CPU tensor; ``mega_spectral_op_plain`` runs
the plain version on any device. ``mega_residency`` is the cut between
the two kernels.
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
    RESIDENT_STAGED,
    RESIDENT_VMEM,
    MegaSpec,
    SegmentSpec,
    SpectralSpec,
    _filter_ref_count,
    apply_exponents,
    check_mega,
    default_factorization,
    device_constants,
    line_exponents,
    mega_plain,
    remove_exponents,
    resolve_precision,
    spectral_plain,
    stockham_radices,
    stockham_table,
)

# Launches of the CUDA spectral kernel in this process (one per call on a
# CUDA tensor, counted where the launch succeeds and nowhere else).
SPECTRAL_LAUNCHES = 0
# Launches of each CUDA megakernel, counted the same way.
MEGA_LAUNCHES = {"mega_resident": 0, "mega_staged": 0}

KERNEL_NAME = "spectral"
KERNEL_MAX_N = 4096
FFT_IMPLS = ("matmul", "stockham")   # the FFT routes of the CUDA kernels
_MODE_CODES = {m: i for i, m in enumerate(FILTER_MODES)}
_ROADMAP = "ROADMAP.md Queue 2, item 1"
# Precisions the CUDA kernels take on each FFT route. The matmul route runs
# its stages on 3xTF32 (f32), or one m16n8k16 pass of bf16 or f16 operands
# (bs16: f16 behind the per-line exponent codec), each with or without
# Karatsuba; the Stockham route has no matrix operands, so bf16 and f16 run
# its f32 passes, bs16 adds the codec, and Karatsuba changes nothing.
KERNEL_PRECISIONS = {"matmul": ("f32", "bf16", "f16", "bs16"),
                     "stockham": ("f32", "bf16", "f16", "bs16")}
# The launchers' operand form of each precision on the matmul route
# (csrc/mma16.cuh, enum Operand); bs16 adds the codec flag.
_OPERANDS = {"f32": 0, "bf16": 1, "f16": 2, "bs16": 2}


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
        fn.argtypes = ([p] * 4 + [i] * 9 + [p] * 11 + [i] + [ll] * 6
                       + [i] * 5 + [p])
        fn.restype = ctypes.c_int
        lib.spectral_error_string.argtypes = [ctypes.c_int]
        lib.spectral_error_string.restype = ctypes.c_char_p
    return lib


# Shared memory one block may opt in to on sm_90 (cudaDevAttr-
# MaxSharedMemoryPerBlockOptin; chip_smoke.py checks it on the card).
SMEM_OPTIN_BYTES = 232_448
# The matmul route's block: 256 to 512 threads, each warp holding one task
# of 4 m16n8 output tiles (16 points a thread) a round of its tensor-core
# stage, which loops over rounds of lines; 256 threads hold a whole line
# of any split of N <= 4096 in one round.
MMA_THREADS = (256, 512)
# The Stockham route's block: at most 512 threads, so that a thread may
# take 128 registers (at 1024 threads and 64 registers its out-of-line ops
# spilled kilobytes and ran slower, PERF.md; the 128^2 resident slab, its
# ops inlined, is the one 1024-thread block, chosen in csrc/mega.cu).
STOCKHAM_THREADS = 512
# Points of one mega_staged tile on the matmul route: 4 lines at N = 4096
# (16-byte runs of the column layout), what a 512-thread block stages in
# two rounds of the tensor-core stage.
STAGED_TILE_POINTS = 16384


def stockham_per_thread(points: int, n: int,
                        threads: int = STOCKHAM_THREADS) -> int:
    """Points a thread of the Stockham route holds in registers when
    ``threads`` threads hold ``points`` points of ``n``-point lines at
    once: 16 (one group of two radix-4 passes), or 32 (two groups) where
    16 do not cover them — the 4-column tile at N = 4096, whose 16-byte
    runs need the 4 columns. The host copy of
    ``csrc/spectral_common.cuh::stockham_per_thread``, which the
    launchers check."""
    return 32 if points > 16 * threads and n >= 32 else 16


def dft_smem_bytes(n1: int, n2: int) -> int:
    """Shared memory of the matmul route's F1 and F2 copy (re, im; rows
    padded to n + 4 floats; one matrix when n1 == n2): 34,816 B at
    64 x 64."""
    return 8 * (n1 * (n1 + 4) + (0 if n1 == n2 else n2 * (n2 + 4)))


def _fit_tile(tile: int, n: int, fft_impl: str, n1: int, n2: int) -> int:
    """Halve ``tile`` until the tile and, on the matmul route, F1 and F2
    fit one block's shared memory (only n1 = 128 overrides need it)."""
    extra = dft_smem_bytes(n1, n2) if fft_impl == "matmul" else 0
    while tile > 1 and tile * n * 8 + extra > SMEM_OPTIN_BYTES:
        tile //= 2
    return tile


def kernel_tile(n: int, axis: int, fft_impl: str = "matmul",
                n1: Optional[int] = None,
                n2: Optional[int] = None) -> tuple[int, int]:
    """(lines per CTA, threads per CTA) of the spectral kernel on one FFT
    route: rows hold 4096/N whole lines (one 32 KiB line at N=4096), cols
    at least 4 adjacent columns so strided loads come in 16-byte runs
    (128 KiB at N = 4096). Stockham: every thread holds
    ``stockham_per_thread`` points in registers through the paired
    passes, tile * N / points threads, no thread idle, at most
    ``STOCKHAM_THREADS``. Matmul (``n1 x n2``, default the two-factor split): 16 points a
    thread a round, 256 to 512 threads (256 for a 4096-point tile: 8 warps
    of 16 x 32 outputs of the 64 x 64 block; 512 for the 16384-point
    column tile, in two rounds); the tile shrinks only where F1 and F2
    would not fit beside it."""
    tile = max(1 if axis == 1 else 4, 4096 // n)
    if fft_impl == "stockham":
        return tile, tile * n // stockham_per_thread(tile * n, n)
    if n1 is None or n2 is None:
        n1, n2 = default_factorization(n)[:2]
    tile = _fit_tile(tile, n, fft_impl, n1, n2)
    lo, hi = MMA_THREADS
    return tile, max(lo, min(hi, tile * n // 16))


def check_kernel_spec(spec: SpectralSpec) -> tuple[int, int]:
    """Raise ValueError for what the CUDA kernel does not take yet;
    returns its two-factor split (n1, n2) on the four-step route
    (``fft_impl="matmul"``) and (n, 1) on the Stockham route, which takes
    any power of two from 2 to 4096 and splits nothing. Every precision
    and ``karatsuba`` are taken on both routes."""
    if spec.fft_impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {spec.fft_impl!r}: the CUDA "
                         f"kernels take {FFT_IMPLS} (ROADMAP.md Queue 2)")
    if spec.n > KERNEL_MAX_N:
        raise ValueError(
            f"n={spec.n} > {KERNEL_MAX_N} is not taken by the CUDA spectral "
            f"kernel yet ({_ROADMAP}d)")
    if spec.fft_impl == "stockham":
        stockham_radices(spec.n)          # a power of two >= 2
        return spec.n, 1
    factors = spec.factors()
    if len(factors) != 2:
        raise ValueError(
            f"the CUDA spectral kernel takes a two-factor split, got "
            f"{factors} ({_ROADMAP}d)")
    return factors


def _ptr(t):
    return None if t is None else t.data_ptr()


def _block_scaled(precision: str) -> int:
    """The launch's codec flag: 1 for bs16 (per-line exponents scaled out
    after the load and folded back at the store), else 0."""
    return int(resolve_precision(precision).block_scaled)


def _karatsuba(spec: SpectralSpec) -> int:
    """The launch's Karatsuba flag: the matmul route's stages alone have
    complex contractions to take it (the Stockham route ignores it, as the
    plain version does)."""
    return int(bool(spec.karatsuba) and spec.fft_impl == "matmul"
               and (spec.fwd or spec.inv))


def _route_constants(spec: SpectralSpec, n1: int, n2: int, dev) -> tuple:
    """The seven constant pointers' tensors of one transform: the four-step
    DFT matrices and twiddles and no Stockham table, or the other way
    round (all None without a transform)."""
    if not (spec.fwd or spec.inv):
        return (None,) * 7
    if spec.fft_impl == "stockham":
        return (None,) * 6 + (stockham_table(spec.n, str(dev)),)
    return (*device_constants((n1, n2), str(dev)), None)


def _filter_launch_args(mode: str, axis: int, filter_args):
    """(tensors, args): the launch arguments (hr, hi, u, v, rank, h_line,
    h_k, u_line, u_k, v_n, v_k) of one filter payload in the kernel
    layouts — element (line, k) of the explicit filter at
    h[line * h_line + k * h_k] (shared vectors have h_line = 0), the
    phase's u (line, q) at u[line * u_line + q * u_k] and v (k, q) at
    v[k * v_n + q * v_k]; pointers are ints or None — and the tensors
    they point into, which the caller keeps alive until the launch."""
    hr = hi = u = v = None
    rank = 1
    h_line = h_k = u_line = u_k = v_n = v_k = 0
    if mode in (FILTER_SHARED, FILTER_FULL, FILTER_SHARED_OUTER):
        hr = filter_args[0].contiguous()
        hi = filter_args[1].contiguous()
        if mode == FILTER_FULL:   # (lines, n) rows / (n, lines) cols
            h_line, h_k = ((hr.stride(0), hr.stride(1)) if axis == 1
                           else (hr.stride(1), hr.stride(0)))
        else:
            h_k = 1
    if mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        u, v = filter_args[-2], filter_args[-1]
        if axis == 1:   # u (L, K), v (K, N)
            rank = u.shape[1]
            u_line, u_k = u.stride(0), u.stride(1)
            v_n, v_k = v.stride(1), v.stride(0)
        else:           # u (K, L), v (N, K)
            rank = u.shape[0]
            u_line, u_k = u.stride(1), u.stride(0)
            v_n, v_k = v.stride(0), v.stride(1)
    return [hr, hi, u, v], (_ptr(hr), _ptr(hi), _ptr(u), _ptr(v), rank,
                            h_line, h_k, u_line, u_k, v_n, v_k)


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
    consts = _route_constants(spec, n1, n2, dev)
    keep, filt = _filter_launch_args(spec.filter_mode, spec.axis,
                                     filter_args)
    if spec.fwd or spec.inv:
        tile, threads = kernel_tile(n, spec.axis, spec.fft_impl, n1, n2)
    else:   # no route's constants: the matmul instantiation, no F1 / F2
        tile, threads = kernel_tile(n, spec.axis, "matmul", 1, 1)
    lib = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spectral_launch(
            _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi),
            b, lines, n, n1, n2, spec.axis, int(spec.fwd), int(spec.inv),
            _MODE_CODES[spec.filter_mode], *(_ptr(c) for c in consts),
            *filt, tile, threads, _block_scaled(spec.precision),
            _OPERANDS[spec.precision], _karatsuba(spec), stream)
    del keep
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
    fft_impl ('matmul' | 'stockham'), karatsuba, precision (f32 | bf16 |
    f16 | bs16), n1/n2/n3 (factorization override). On a CUDA tensor this
    launches the CUDA kernel, which takes N <= 4096 and both FFT routes at
    every precision (a two-factor split, and Karatsuba, on the matmul
    route) and raises ValueError for anything else; on a CPU tensor it runs
    the plain version, which takes all of them.
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


# ---------------------------------------------------------------------------
# The megakernel: a multi-axis segment chain in one launch
# ---------------------------------------------------------------------------

MEGA_KERNEL_NAME = "mega"
# The library of the matmul route's other operand forms (bf16, f16, bs16,
# Karatsuba): csrc/mega_forms.cu, built from mega.cu beside it.
MEGA_FORMS_NAME = "mega_forms"
# Points the resident kernel's slab may hold besides the shared-memory
# limit: what the Stockham route holds in registers at once (16 points a
# thread of 1024 for 128^2); the matmul route stages them at 512 threads
# in rounds of lines, so the cut is the same on both routes.
RESIDENT_MAX_POINTS = 16384
MEGA_MAX_SEGMENTS = 8
_SEG_FIELDS = 27            # int64 fields per segment in the launch table


def mega_residency(na: int, nr: int, batch_block: int = 1,
                   precision: Optional[str] = None,
                   filter_bytes: int = 0) -> str:
    """The residency the compiler picks when none is pinned: ``"vmem"``
    iff a ``batch_block``-scene split f32 slab (8 B a point) fits one
    block's opt-in shared memory and its register staging, else
    ``"staged"`` (128^2 -> vmem; 256^2 and 4096^2 -> staged).

    The Hopper counterpart of the reference's VMEM cut. The slab is f32 at
    every precision (only DFT operands narrow), and the DFT constants and
    filters are read from global memory in place, so ``precision`` is only
    validated and ``filter_bytes`` takes no shared memory."""
    resolve_precision(precision)
    del filter_bytes
    points = (batch_block or 1) * na * nr
    fits = points * 8 <= SMEM_OPTIN_BYTES and points <= RESIDENT_MAX_POINTS
    return RESIDENT_VMEM if fits else RESIDENT_STAGED


def _mega_prepare(na, nr, filter_args, *, segments, residency, batch_block,
                  phase_block, buffer_depth, fft_impl, karatsuba, precision,
                  n1, n2, n3):
    """Parse segment records and lay the scene-coordinate filter payloads
    out in kernel layout: (spec, prepared filter args)."""
    segs = []
    args = list(filter_args)
    prepared = []
    ai = 0
    for rec in segments:
        if len(rec) == 4:
            (axis, fwd, inv, fmode), seg_kw = rec, {}
        elif len(rec) == 8:
            axis, fwd, inv, fmode = rec[:4]
            seg_kw = dict(zip(("n1", "n2", "n3", "karatsuba"), rec[4:]))
        else:
            raise ValueError(
                f"segment record must have 4 fields (axis, fwd, inv, "
                f"filter_mode) or 8 (+ n1, n2, n3, karatsuba), got "
                f"{len(rec)}")
        if fmode not in FILTER_MODES:
            raise ValueError(f"unknown filter_mode {fmode!r}")
        n = nr if axis == 1 else na
        rank = 1
        if fmode in (FILTER_SHARED, FILTER_FULL, FILTER_SHARED_OUTER):
            hr, hi = args[ai], args[ai + 1]
            ai += 2
            if fmode == FILTER_FULL:
                prepared += [hr, hi]
            else:
                shape = (1, n) if axis == 1 else (n, 1)
                prepared += [hr.reshape(shape), hi.reshape(shape)]
        if fmode in (FILTER_OUTER, FILTER_SHARED_OUTER):
            u, v = args[ai], args[ai + 1]
            ai += 2
            u = u.reshape(u.shape[0], -1)
            v = v.reshape(v.shape[0], -1)
            rank = u.shape[1]
            prepared += ([u, v.T] if axis == 1 else [u.T, v])
        segs.append(SegmentSpec(axis=axis, fwd=fwd, inv=inv,
                                filter_mode=fmode, outer_rank=rank, **seg_kw))
    if ai != len(args):
        raise ValueError(
            f"got {len(args)} filter arrays but segments consume {ai}")
    spec = MegaSpec(
        na=na, nr=nr, segments=tuple(segs), residency=residency,
        batch_block=batch_block, phase_block=phase_block,
        buffer_depth=buffer_depth, n1=n1, n2=n2, n3=n3, fft_impl=fft_impl,
        karatsuba=karatsuba, precision=precision)
    return spec, prepared


def _bind_mega(name: str = MEGA_KERNEL_NAME):
    lib = _build.load(name)
    if lib.mega_resident_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mega_resident_launch.argtypes = [p] * 4 + [i] * 6 + [p, p]
        lib.mega_staged_launch.argtypes = [p] * 4 + [i] * 7 + [p, p]
        for fn in (lib.mega_resident_launch, lib.mega_staged_launch):
            fn.restype = ctypes.c_int
        if name == MEGA_KERNEL_NAME:   # the f32 and Stockham kernels'
            lib.mega_staged_blocks_per_sm.argtypes = [ctypes.c_longlong, i]
            lib.mega_staged_blocks_per_sm.restype = ctypes.c_int
        lib.mega_smem_optin.argtypes = [i]
        lib.mega_smem_optin.restype = ctypes.c_int
        lib.mega_error_string.argtypes = [i]
        lib.mega_error_string.restype = ctypes.c_char_p
    return lib


def staged_tile(n: int, lines: int, fft_impl: str, n1: int,
                n2: int, axis: int = 0) -> int:
    """Lines per tile of one ``mega_staged`` phase, never more than the
    scene has. Matmul: whole lines of ``STAGED_TILE_POINTS`` (4 rows or
    columns at N = 4096), the tile and the phase's F1 and F2
    (``n1 x n2``) sharing the block's shared memory. Stockham: the lines
    ``STOCKHAM_THREADS`` threads hold at 16 points a thread (2 rows at
    N = 4096: 4 rows at 32 a thread spilled ~1.9 KB, PERF.md), or the
    spectral kernel's tile where that is wider (the 4 columns at
    N = 4096, 32 points a thread)."""
    if fft_impl == "stockham":
        tile = max(kernel_tile(n, axis, fft_impl)[0],
                   16 * STOCKHAM_THREADS // n)
        return min(tile, lines)
    tile = min(max(1, STAGED_TILE_POINTS // n), lines)
    return _fit_tile(tile, n, fft_impl, n1, n2)


def check_mega_kernel(spec: MegaSpec) -> None:
    """Raise ValueError for what the CUDA megakernels do not take yet."""
    if len(spec.segments) > MEGA_MAX_SEGMENTS:
        raise ValueError(f"the CUDA megakernels take at most "
                         f"{MEGA_MAX_SEGMENTS} segments, got "
                         f"{len(spec.segments)}")
    for seg in spec.segments:
        sspec = spec.seg_spec(seg)
        if sspec.n > KERNEL_MAX_N:
            raise ValueError(
                f"n={sspec.n} > {KERNEL_MAX_N} is not taken by the CUDA "
                f"megakernels yet ({_ROADMAP}d)")
        if seg.fwd or seg.inv:
            check_kernel_spec(sspec)
    if spec.residency == RESIDENT_VMEM:
        if (spec.batch_block or 1) != 1:
            raise ValueError("the CUDA mega_resident kernel holds one scene "
                             f"per block; batch_block={spec.batch_block}")
        if mega_residency(spec.na, spec.nr) != RESIDENT_VMEM:
            raise ValueError(
                f"residency='vmem': a {spec.na}x{spec.nr} scene does not fit "
                f"one block's shared memory ({SMEM_OPTIN_BYTES} B, "
                f"{RESIDENT_MAX_POINTS} points); use residency='staged'")


def _launch_mega(spec: MegaSpec, xr, xi, filter_args):
    b = xr.shape[0]
    check_mega_kernel(spec)
    dev = xr.device
    for t in (xr, xi, *filter_args):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA megakernels take float32, "
                             f"got {t.dtype}")
    xr = xr.contiguous()
    xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if yr.numel() == 0:
        return yr, yi
    it = iter(filter_args)
    table = []
    keep = []            # tensors whose pointers the table holds
    for seg in spec.segments:
        sspec = spec.seg_spec(seg)
        lines = spec.na if seg.axis == 1 else spec.nr
        fargs = [next(it)
                 for _ in range(_filter_ref_count(seg.filter_mode))]
        tensors, (hr, hi, u, v, rank, h_line, h_k, u_line, u_k, v_n,
                  v_k) = _filter_launch_args(seg.filter_mode, seg.axis, fargs)
        keep += tensors
        n1 = n2 = 1
        if seg.fwd or seg.inv:
            n1, n2 = check_kernel_spec(sspec)
        *consts, stw = _route_constants(sspec, n1, n2, dev)
        table.append([
            seg.axis, int(seg.fwd), int(seg.inv),
            _MODE_CODES[seg.filter_mode], rank, sspec.n, n1, n2,
            staged_tile(sspec.n, lines, sspec.fft_impl, n1, n2, seg.axis),
            *(_ptr(c) or 0 for c in consts),
            hr or 0, hi or 0, h_line, h_k, u or 0, v or 0,
            u_line, u_k, v_n, v_k, _ptr(stw) or 0, _karatsuba(sspec)])
    flat = [int(f) for rec in table for f in rec]
    assert len(flat) == _SEG_FIELDS * len(table)
    ctable = (ctypes.c_longlong * len(flat))(*flat)
    bs = _block_scaled(spec.precision)
    op = _OPERANDS[spec.precision]
    # a chain without a transform runs no stage: the f32 form (or, with
    # bs16, the Stockham route's codec), in mega.cu's library; the matmul
    # route's other forms are mega_forms.cu's
    has_fft = any(seg.fwd or seg.inv for seg in spec.segments)
    if not has_fft and not bs:
        op = 0
    forms = has_fft and spec.fft_impl == "matmul" and (
        op != 0 or any(rec[-1] for rec in table))
    lib = _bind_mega(MEGA_FORMS_NAME if forms else MEGA_KERNEL_NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (_ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), b, spec.na, spec.nr,
                len(table))
        if spec.residency == RESIDENT_VMEM:
            kernel = "mega_resident"
            err = lib.mega_resident_launch(*head, bs, op, ctable, stream)
        else:
            kernel = "mega_staged"
            err = lib.mega_staged_launch(*head, spec.buffer_depth, bs, op,
                                         ctable, stream)
    del keep
    if err != 0:
        msg = lib.mega_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed ({err}): {msg}")
    MEGA_LAUNCHES[kernel] += 1
    return yr, yi


def _mega(xr, xi, filter_args, plain: bool, *, segments,
          residency: str = RESIDENT_VMEM, batch_block: Optional[int] = None,
          phase_block: int = 8, buffer_depth: int = 2,
          fft_impl: str = "matmul", karatsuba: bool = False,
          precision: Optional[str] = None, n1: Optional[int] = None,
          n2: Optional[int] = None, n3: Optional[int] = None, exp_in=None,
          return_exp: bool = False):
    prec = resolve_precision(precision)
    if (exp_in is not None or return_exp) and not prec.block_scaled:
        raise ValueError(
            "exp_in/return_exp carry block exponents and require a "
            f"block-scaled precision, got {prec.name!r}")
    batched = xr.ndim == 3
    if not batched:
        xr = xr[None]
        xi = xi[None]
    if exp_in is not None:
        xr, xi = apply_exponents(xr, xi, exp_in)
    spec, prepared = _mega_prepare(
        xr.shape[1], xr.shape[2], filter_args, segments=segments,
        residency=residency, batch_block=batch_block, phase_block=phase_block,
        buffer_depth=buffer_depth, fft_impl=fft_impl, karatsuba=karatsuba,
        precision=prec.name, n1=n1, n2=n2, n3=n3)
    if plain or xr.device.type == "cpu":
        yr, yi = mega_plain(spec, xr, xi, *prepared)
    elif xr.device.type == "cuda":
        check_mega(spec, xr.shape[0])
        yr, yi = _launch_mega(spec, xr, xi, prepared)
    else:
        raise ValueError(f"no megakernel for device {xr.device}")
    if return_exp:
        exp = line_exponents(yr, yi, spec.segments[-1].axis)
        yr, yi = remove_exponents(yr, yi, exp)
        if not batched:
            return yr[0], yi[0], exp[0]
        return yr, yi, exp
    if not batched:
        return yr[0], yi[0]
    return yr, yi


def mega_spectral_op(xr, xi, *filter_args, **kw):
    """A whole multi-axis spectral chain — ``fft? mul* ifft?`` segments
    with the corner turns between them — as ONE launch.

    x: one scene (na, nr) or a batch (B, na, nr), split re/im float32 in
    scene layout (azimuth rows x range samples). ``segments`` is a tuple
    of ``(axis, fwd, inv, filter_mode)`` records in execution order (axis
    1 transforms range, 0 azimuth), or 8-field records that add this
    segment's ``(n1, n2, n3, karatsuba)``. ``filter_args`` follow in
    segment order, each segment's payload in SCENE coordinates
    (n = transformed-axis length, lines = the other axis):

      shared:       hr (n,), hi (n,)
      full:         hr (na, nr), hi (na, nr)
      outer:        u (lines,) or (lines, K); v (n,) or (n, K)
      shared_outer: hr, hi, u, v

    Keywords as the reference's: ``residency`` ('vmem': on Hopper the
    whole scene stays in one block's shared memory; 'staged': phases
    through device memory), ``batch_block``, ``phase_block`` and
    ``buffer_depth`` (validated; the staged kernel picks its own tiles and
    does not prefetch yet), ``fft_impl``, ``karatsuba``, ``precision``,
    ``n1/n2/n3`` (range-axis factorization), ``exp_in`` / ``return_exp``
    (bs16: carry the per-line exponents across calls — the result comes
    back scaled with the exponents along the last segment's free axis).

    On a CUDA tensor this launches ``mega_resident`` or ``mega_staged``
    (N <= 4096, at most 8 segments, both FFT routes at every precision —
    bs16 runs the codec in each segment — with a two-factor split and
    Karatsuba per segment on the matmul route) and raises ValueError for
    anything else — including a forced 'vmem' on a scene that does not
    fit; on a CPU tensor it runs
    ``fft4step.mega_plain``, which takes all of them.
    """
    return _mega(xr, xi, filter_args, False, **kw)


def mega_spectral_op_plain(xr, xi, *filter_args, **kw):
    """``mega_spectral_op`` through the plain version on any device."""
    return _mega(xr, xi, filter_args, True, **kw)
