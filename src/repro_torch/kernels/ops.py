"""Public wrappers around the fused spectral op and the megakernel.

All functions take and return split re/im float32 tensors. Each wrapper
accepts one scene — (lines, N) rows layout / (N, lines) cols layout — or
a batch with a leading batch dim, (B, lines, N) / (B, N, lines), run as
ONE launch; 2-D inputs are treated as B=1 and squeezed on return. Filter
arguments are unbatched (scenes share the SceneConfig filters).

Where it runs is decided by the tensors alone:

* a CUDA tensor launches the hand-written kernel ``csrc/spectral.cu``
  (one launch per call, counted in ``SPECTRAL_LAUNCHES``; a line past one
  block its cooperative ``spectral_long``, the forms other than f32 from
  ``csrc/spectral_long_forms.cu``), or raises — there is no fallback;
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
import dataclasses
import math
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
    MAX_FACTOR,
    RESIDENT_STAGED,
    RESIDENT_VMEM,
    MegaSpec,
    SegmentSpec,
    SpectralSpec,
    TILE_MAX_N,
    _filter_ref_count,
    apply_exponents,
    check_mega,
    default_factorization,
    device_constants,
    four_step_twiddle_tensors,
    line_exponents,
    mega_plain,
    remove_exponents,
    resolve_precision,
    spectral_plain,
    stockham_radices,
    stockham_split,
    stockham_table,
)

# Launches of the CUDA spectral kernel in this process (one per call on a
# CUDA tensor, counted where the launch succeeds and nowhere else).
SPECTRAL_LAUNCHES = 0
# Launches of each CUDA megakernel, counted the same way.
MEGA_LAUNCHES = {"mega_resident": 0, "mega_staged": 0}

KERNEL_NAME = "spectral"
# The longest line the kernels take (the reference's three-factor limit,
# 128^3); lines past TILE_MAX_N, and three-factor splits, run as passes
# over device memory in the same one launch (csrc/long_lines.cuh).
KERNEL_MAX_N = MAX_FACTOR ** 3
FFT_IMPLS = ("matmul", "stockham")   # the FFT routes of the CUDA kernels
_MODE_CODES = {m: i for i, m in enumerate(FILTER_MODES)}
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

# The library of spectral_long's forms other than f32 (bf16, f16, bs16,
# Karatsuba past one block): csrc/spectral_long_forms.cu, built from
# spectral.cu beside it.
SPECTRAL_LONG_FORMS_NAME = "spectral_long_forms"


def _bind(name: str = KERNEL_NAME):
    lib = _build.load(name)
    fn = lib.spectral_long_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == KERNEL_NAME:    # the tile kernel's entry point
            lib.spectral_launch.argtypes = (
                [p] * 4 + [i] * 9 + [p] * 11 + [i] + [ll] * 6 + [i] * 5
                + [p])
            lib.spectral_launch.restype = ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [p] + [i] * 2 + [p, p]
        fn.restype = ctypes.c_int
        if name == KERNEL_NAME:
            lib.spectral_long_blocks_per_sm.argtypes = [ll, i]
            lib.spectral_long_blocks_per_sm.restype = ctypes.c_int
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


@dataclasses.dataclass(frozen=True)
class LongGeometry:
    """The passes over device memory of one long op (``long_geometry``;
    ``csrc/long_lines.cuh`` runs them in one cooperative launch).

    A line of N = d_1 ... d_D * B points: the device-memory passes
    transform the leading factors ``digits`` (the matmul route's leading
    factors, or the Stockham route's N / ``TILE_MAX_N``), one pass each,
    the tiles of digit i holding ``digit_tiles[i]`` sub-lines of d_i
    points, on the matmul route in the stages ``digit_splits[i]`` (fa, fb)
    (fb = 1: one stage); the tail pass transforms B = prod(``tail``)
    points a line, ``tail_tile`` lines a tile (the matmul route's one or
    two factors, the Stockham route's ``TILE_MAX_N``). A filter-only op
    has no digits and no tail: one elementwise pass. ``natural``: the
    matmul route's 16-bit forms, whose inverse runs the forward's passes on
    natural order (conj, forward, conj x 1/N, as the plain version rounds
    it), so a forward + inverse op runs the forward's passes twice.
    ``whole_line``: the rows layout with one digit and ``LINE_MIN_N`` <=
    N <= ``LINE_MAX_N``, where a digit tile is a whole line: every pass runs
    in one tile a line, in shared memory, and the op reads and writes
    device memory once (``csrc/long_lines.cuh``'s ``line_plan``).
    ``ring``: the tile passes load their tiles through the asynchronous
    ring (``LONG_RING``; ``ring_bytes``), the tiles sized for it."""

    digits: tuple[int, ...]
    tail: tuple[int, ...]
    digit_tiles: tuple[int, ...]
    tail_tile: int
    fft_impl: str
    digit_splits: tuple[tuple[int, int], ...] = ()
    natural: bool = False
    whole_line: bool = False
    ring: bool = False

    @property
    def tail_n(self) -> int:
        return math.prod(self.tail) if self.tail else 0

    def tile_passes(self, fwd: bool, inv: bool) -> int:
        """Passes of the four-step's schedule: each digit once a
        direction and the tail once (twice in a natural fwd + inv op); a
        filter-only op one. A whole-line tile (and ``mega_resident``'s
        slab) runs them in shared memory."""
        d = len(self.digits)
        if not (fwd or inv):
            return 1
        if fwd and inv:
            return 2 * d + (2 if self.natural else 1)
        return d + 1

    def passes(self, fwd: bool, inv: bool) -> int:
        """Passes over device memory (grid barriers + 1) of an op: one
        for a whole-line op, else ``tile_passes``."""
        if self.whole_line and (fwd or inv):
            return 1
        return self.tile_passes(fwd, inv)

    def smem_bytes(self) -> int:
        """Shared memory of the largest pass: its tile and, on the matmul
        route, the DFT matrix (or the tail's pair) past it; the Stockham
        route rounds a tile up to whole runs of 16 points; then the ring
        where the pass takes one (``ring_bytes``). A whole-line op: the
        line, then the digit's matrices and the tail's where each fits
        beside it (else the stages read them from device memory)."""
        if not self.tail:
            return 0
        stockham = self.fft_impl == "stockham"

        def tile_bytes(points, mats):
            if stockham:
                return 8 * ((points + 15) // 16 * 16)
            return 8 * points + mats

        splits = self.digit_splits or [(f, 1) for f in self.digits]
        dig = [dft_smem_bytes(*(sp if sp[1] > 1 else (f, f)))
               for f, sp in zip(self.digits, splits)]
        pads = [_digit_pad(sp[1], self.fft_impl) for sp in splits]
        t = self.tail if len(self.tail) == 2 else self.tail * 2
        if self.whole_line:   # the line, its rows pads[0] points apart
            out = tile_bytes(self.digits[0] * (self.tail_n + pads[0]), 0)
            for mats in (dig[0], dft_smem_bytes(*t)):
                if not stockham and out + mats <= SMEM_OPTIN_BYTES:
                    out += mats
            return out
        tiles = [(f * c, tile_bytes(f * (c + pad), m)) for f, c, m, pad in
                 zip(self.digits, self.digit_tiles, dig, pads)]
        tiles.append((self.tail_n * self.tail_tile,
                      tile_bytes(self.tail_n * self.tail_tile,
                                 dft_smem_bytes(*t))))
        return max(b + ring_bytes(self.ring, b, pts) for pts, b in tiles)


# The tile passes' asynchronous ring (``csrc/long_lines.cuh``'s
# ``pass_ring``): ``RING_SLOTS`` slots past a pass's tile, each a tile's
# points as device memory holds them (8 bytes a point), where its tiles
# reach ``TILE_VEC_POINTS`` points (the 16-byte groups) and the slots fit
# beside the tile; the tiles are sized for it while ``LONG_RING`` is set
# (``long_geometry``). Off: on the H100 every long op measured took
# 5-62 % longer with it (its tiles halved, its slots in L1's place;
# PERF.md); ``chip_smoke.py --long-passes ring`` times both, and
# the tests hold the two bit for bit equal.
LONG_RING = False
RING_SLOTS = 2
TILE_VEC_POINTS = 2048


def ring_bytes(ring: bool, tile_bytes: int, points: int) -> int:
    """Bytes the ring adds past a tile of ``points`` points that takes
    ``tile_bytes`` of shared memory (its slots start 16-byte aligned), or
    0 where the pass takes none (``csrc/long_lines.cuh``'s
    ``ring_bytes``)."""
    if not ring or points < TILE_VEC_POINTS:
        return 0
    end = -(-tile_bytes // 16) * 16 + RING_SLOTS * 8 * points
    return end - tile_bytes if end <= SMEM_OPTIN_BYTES else 0


def _fit_ring(c: int, points, tile_bytes) -> int:
    """The largest of c, c / 2, ... whose tile of ``points(c)`` points and
    ``tile_bytes(c)`` bytes takes the ring, else ``c`` (no ring fits a
    tile of the 16-byte groups' size)."""
    r = c
    while r > 1 and not ring_bytes(True, tile_bytes(r), points(r)):
        r //= 2
    return r if ring_bytes(True, tile_bytes(r), points(r)) else c


# The lines a whole-line tile holds (``LongGeometry.whole_line``): at most
# 128 KiB of f32 points in one block's shared memory, at least a block's
# worth (a shorter line leaves most of a tile a line idle).
LINE_MAX_N = 16384
LINE_MIN_N = 4096


# The longest sum of products one tensor-core stage of the long passes
# takes at f32: a larger factor runs in two stages (``_stage_split``). The
# tensor cores' accumulation truncates, so a long sum strays further (at
# 128-term sums the 8192 x 16384 image missed complex128 by 1.04e-5,
# PERF.md). The 16-bit forms take every factor in one stage: the plain
# version rounds a factor's operands once and sums all its terms in f32,
# and a stage between would round an intermediate it never rounds.
LONG_STAGE_MAX = 16


def _narrow_operands(spec: SpectralSpec) -> bool:
    """The matmul route's 16-bit forms (bf16, f16, bs16): one stage a
    factor, and the natural schedule past one block."""
    return spec.fft_impl == "matmul" and \
        resolve_precision(spec.precision).dtype != "float32"


def _stage_split(f: int, narrow: bool = False) -> tuple[int, int]:
    """(fa, fb) of an f-point transform in a long pass on the matmul
    route: (f, 1), one stage, up to ``LONG_STAGE_MAX`` (every f in the
    16-bit forms, ``narrow``); else the two-factor split (32 = 8 x 4,
    64 = 8 x 8, 128 = 16 x 8)."""
    return (f, 1) if narrow or f <= LONG_STAGE_MAX \
        else default_factorization(f)


def _digit_pad(fb: int, fft_impl: str) -> int:
    """Points between the matmul route's digit rows in shared memory past
    their sub-lines (``csrc/long_lines.cuh``'s ``digit_pad``): 1 for a
    two-stage digit (fb > 1), 4 for one stage, none on the Stockham route
    (it swizzles): rows of 64 or 128 points put the stages' reads down the
    sub-lines on one bank pair."""
    if fft_impl == "stockham":
        return 0
    return 1 if fb > 1 else 4


def _long_digit_tile(f: int, rest: int, fft_impl: str,
                     narrow: bool = False, ring: bool = False) -> int:
    """Sub-lines of one digit pass's tile: Stockham, what 512 threads hold
    at 16 points a thread; matmul, at most 16384 points beside the digit's
    DFT matrices in shared memory, and in one stage (f <= 16, every f
    when ``narrow``) at most the columns one round of it takes (the f x C
    tile is one line of C columns); with ``ring``, halved until the ring
    fits beside it (``_fit_ring``). Never more than the ``rest``
    sub-lines of a block."""
    if fft_impl == "stockham":
        c = max(1, 16 * STOCKHAM_THREADS // f)
        return min(c, rest)
    fa, fb = _stage_split(f, narrow)
    c = max(1, 16384 // f)
    if fb == 1:
        c = min(c, MMA_THREADS[1] // 32 // -(-f // 16) * 32)
    mats = dft_smem_bytes(fa, fb) if fb > 1 else dft_smem_bytes(f, f)
    pad = _digit_pad(fb, fft_impl)
    while c > 1 and 8 * (c + pad) * f + mats > SMEM_OPTIN_BYTES:
        c //= 2
    if ring:
        c = _fit_ring(c, lambda r: f * r,
                      lambda r: 8 * (r + pad) * f + mats)
    return min(c, rest)


def _long_tail_tile(tail: tuple[int, ...], fft_impl: str,
                    axis: int = 1, ring: bool = False) -> int:
    """Lines of one tail tile: Stockham, what 512 threads hold at 16
    points a thread, on the columns layout at least 4 (a 16-byte run of
    each row: 2 lines of 4096 points left 8 bytes a row and plane, a
    quarter of each 32-byte sector), in rounds; matmul, 16384 points,
    beside the tail's DFT matrices, and with one factor at most one round
    of the stage's columns (the lines are its columns), with ``ring``
    halved until the ring fits beside them (``_fit_ring``)."""
    b = math.prod(tail)
    if fft_impl == "stockham":
        c = max(1, 16 * STOCKHAM_THREADS // b)
        return max(c, 4) if axis == 0 and 4 * b <= LINE_MAX_N else c
    c = max(1, 16384 // b)
    if len(tail) == 1:
        c = min(c, MMA_THREADS[1] // 32 // -(-b // 16) * 32)
    mats = dft_smem_bytes(*(tail if len(tail) == 2 else tail * 2))
    while c > 1 and 8 * c * b + mats > SMEM_OPTIN_BYTES:
        c //= 2
    if ring:
        c = _fit_ring(c, lambda r: r * b, lambda r: 8 * r * b + mats)
    return c


def long_geometry(spec: SpectralSpec) -> Optional[LongGeometry]:
    """The device-memory passes of ``spec`` on the CUDA kernels, or None
    where one block holds a whole line (N <= ``TILE_MAX_N`` with a
    two-factor split, or the Stockham route). The matmul route's leading
    factor is a pass, and the next too where the last two multiply past
    ``TILE_MAX_N`` (128^3); the Stockham route splits N into
    N / ``TILE_MAX_N`` x ``TILE_MAX_N`` (``fft4step.stockham_split``).
    The matmul route's 16-bit forms run each factor in one stage and the
    natural schedule (``LongGeometry.natural``); the tile passes take the
    ring as ``LONG_RING`` says (``LongGeometry.ring``)."""
    if not (spec.fwd or spec.inv):
        if spec.n <= TILE_MAX_N:
            return None
        return LongGeometry((), (), (), 0, spec.fft_impl)
    narrow = _narrow_operands(spec)
    if spec.fft_impl == "stockham":
        if spec.n <= TILE_MAX_N:
            return None
        digits, tail = (stockham_split(spec.n)[0],), (TILE_MAX_N,)
        splits = ()
    else:
        fs = spec.factors()
        if len(fs) == 2 and spec.n <= TILE_MAX_N:
            return None
        cut = 2 if len(fs) == 3 and fs[1] * fs[2] > TILE_MAX_N else 1
        digits, tail = fs[:cut], fs[cut:]
        if len(tail) == 1:          # its stages as a digit's
            tail = tuple(f for f in _stage_split(tail[0], narrow) if f > 1)
        splits = tuple(_stage_split(f, narrow) for f in digits)
    rest, tiles = spec.n, []
    for f in digits:
        rest //= f
        tiles.append(_long_digit_tile(f, rest, spec.fft_impl, narrow,
                                      LONG_RING))
    whole = spec.axis == 1 and len(digits) == 1 and \
        LINE_MIN_N <= spec.n <= LINE_MAX_N
    return LongGeometry(digits, tail, tuple(tiles),
                        _long_tail_tile(tail, spec.fft_impl, spec.axis,
                                        LONG_RING),
                        spec.fft_impl,
                        splits, narrow, whole, LONG_RING)


def check_kernel_spec(spec: SpectralSpec) -> tuple[int, ...]:
    """Raise ValueError for what the CUDA kernel does not take; returns the
    split (n1, n2[, n3]) of the four-step route (``fft_impl="matmul"``)
    and (n, 1) on the Stockham route, which splits nothing. Both routes
    take every power of two N up to ``KERNEL_MAX_N`` (2^21), the matmul
    route every split of two or three factors up to 128, at every
    precision, with or without Karatsuba; a line past ``TILE_MAX_N`` or a
    three-factor split runs as passes over device memory
    (``long_geometry``)."""
    if spec.fft_impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {spec.fft_impl!r}: the CUDA "
                         f"kernels take {FFT_IMPLS} (ROADMAP.md Queue 2)")
    if spec.n > KERNEL_MAX_N:
        raise ValueError(
            f"n={spec.n} > {KERNEL_MAX_N} is taken by no route of the CUDA "
            f"kernels, nor by the reference's factorization")
    if spec.fft_impl == "stockham":
        stockham_radices(spec.n)          # a power of two >= 2
        split = (spec.n, 1)
    else:
        split = spec.factors()
    return split


def long_blocks_per_sm(kernel: str, fft_impl: str, smem: int) -> int:
    """Blocks of a long op's f32 cooperative launch one SM of the card
    holds at ``smem`` bytes of dynamic shared memory: ``spectral_long``
    (``kernel="spectral"``) or ``mega_staged``'s instantiation for chains
    with a segment past one block (``kernel="mega_staged"``); its grid is
    this times the SM count, at most the op's tiles (a whole-line op's:
    its lines). -1 where the card refuses the size."""
    stockham = int(fft_impl == "stockham")
    if kernel == "spectral":
        return _bind(KERNEL_NAME).spectral_long_blocks_per_sm(smem,
                                                              stockham)
    return _bind_mega(MEGA_STAGED_NAMES[MEGA_LONG_NAME]) \
        .mega_staged_long_blocks_per_sm(smem, stockham)


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


# The long fields of a segment record (after the 27 of every segment): on,
# digits, tail tile, the ring, scratch re / im, then per digit (factor,
# tile, fb,
# F_fa re, F_fa im, F_fb re, F_fb im, (fa, fb) twiddle re, im, Stockham
# table, four-step twiddle re, im), csrc/long_lines.cuh.
_DIGIT_FIELDS = 12
_LONG_FIELDS = 6 + _DIGIT_FIELDS * 2


def _long_fields(spec: SpectralSpec, geom: LongGeometry, dev, scratch):
    """(head, long fields, tensors to keep alive) of a long op's record:
    head = (n, n1, n2, tile, (F1 re, F1 im, F2 re, F2 im, tw re, tw im),
    Stockham table) of its tail's transform — the two-factor split's, one
    factor's as (B, 1), the Stockham route's (B, 1) with B's table — and
    the device-memory digits' fields (``_LONG_FIELDS``). ``scratch``: the
    (re, im) buffer a forward-only or inverse-only op (a natural one in
    every direction) moves its permuted lines through, or None."""
    keep, digits = [], []
    rest = spec.n
    for i, (f, c) in enumerate(zip(geom.digits, geom.digit_tiles)):
        rest //= f
        tw = four_step_twiddle_tensors(f, rest, str(dev))
        if spec.fft_impl == "stockham":
            fb, stages, stw = 0, (None,) * 6, stockham_table(f, str(dev))
        else:   # F_fa, F_fb and their twiddle; F_f alone in one stage
            fb, stw = geom.digit_splits[i][1], None
            stages = device_constants(geom.digit_splits[i] if fb > 1
                                      else (f,), str(dev))
            stages = (*stages, *(None,) * (6 - len(stages)))
        keep += [t for t in (*tw, *stages, stw) if t is not None]
        digits.append((f, c, fb, stages, stw, *tw))
    if not geom.tail:                 # filter-only: one elementwise pass
        head = (spec.n, 1, 1, 0, (None,) * 6, None)
    elif spec.fft_impl == "stockham":
        tstw = stockham_table(geom.tail_n, str(dev))
        keep.append(tstw)
        head = (geom.tail_n, geom.tail_n, 1, geom.tail_tile, (None,) * 6,
                tstw)
    else:
        tconsts = device_constants(geom.tail, str(dev))
        keep += tconsts
        split = geom.tail if len(geom.tail) == 2 else (geom.tail_n, 1)
        head = (geom.tail_n, *split, geom.tail_tile,
                (*tconsts, *(None,) * (6 - len(tconsts))), None)
    sr, si = scratch if scratch is not None else (None, None)
    fields = [1, len(digits), geom.tail_tile, int(geom.ring), _ptr(sr) or 0,
              _ptr(si) or 0]
    for i in range(2):
        if i < len(digits):
            f, c, fb, stages, stw, twr, twi = digits[i]
            fields += [f, c, fb, *(_ptr(t) or 0 for t in
                                   (*stages, stw, twr, twi))]
        else:
            fields += [0] * _DIGIT_FIELDS
    assert len(fields) == _LONG_FIELDS
    return head, fields, keep


def _needs_scratch(spec: SpectralSpec, geom: LongGeometry) -> bool:
    """A forward-only or inverse-only long op moves its lines between
    the spectrum's order and the natural one through a scratch slab, and
    so does every natural one (the 16-bit forms); a whole-line op moves
    them in its tile, and a filter-only op has no such move."""
    if not geom.tail or geom.whole_line:
        return False
    return spec.fwd != spec.inv or (
        _narrow_operands(spec) and (spec.fwd or spec.inv))


def _codec_words(spec: SpectralSpec, batch: int, lines: int, dev):
    """bs16's words of a long op, one int32 a (scene, line) (the kernel
    zeroes them before its reduction phase), or None."""
    if not resolve_precision(spec.precision).block_scaled:
        return None
    return torch.empty(batch * lines, dtype=torch.int32, device=dev)


def _launch_operand(spec: SpectralSpec) -> int:
    """The launch's operand form: a filter-only op runs no stage, so f32
    unless it carries bs16's codec (the launchers take the same rule)."""
    if not (spec.fwd or spec.inv) and not _block_scaled(spec.precision):
        return 0
    return _OPERANDS[spec.precision]


def _long_library(spec: SpectralSpec, kernel: str, forms: str) -> str:
    """The library of a long op: the f32 form's (the Stockham route's bf16
    and f16 run its f32 passes), or the other forms'."""
    other = _block_scaled(spec.precision) or (
        spec.fft_impl == "matmul" and (spec.fwd or spec.inv) and (
            _OPERANDS[spec.precision] != 0 or bool(spec.karatsuba)))
    return forms if other else kernel


def _launch_long(spec: SpectralSpec, geom: LongGeometry, xr, xi,
                 filter_args):
    """One op on lines past one block (or a three-factor split): the
    device-memory passes of ``csrc/long_lines.cuh`` in ONE cooperative
    launch of spectral.cu's ``spectral_long``."""
    global SPECTRAL_LAUNCHES
    b = xr.shape[0]
    n = spec.n
    lines = xr.shape[2] if spec.axis == 0 else xr.shape[1]
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if yr.numel() == 0:
        return yr, yi
    dev = xr.device
    scratch = ((torch.empty_like(xr), torch.empty_like(xi))
               if _needs_scratch(spec, geom) else None)
    ex = _codec_words(spec, b, lines, dev)
    keep, filt = _filter_launch_args(spec.filter_mode, spec.axis,
                                     filter_args)
    head, fields, keep2 = _long_fields(spec, geom, dev, scratch)
    rec = _record(spec.axis, spec.fwd, spec.inv, spec.filter_mode, filt,
                  head, _karatsuba(spec), fields)
    ctable = (ctypes.c_longlong * len(rec))(*rec)
    na, nr = (lines, n) if spec.axis == 1 else (n, lines)
    lib = _bind(_long_library(spec, KERNEL_NAME, SPECTRAL_LONG_FORMS_NAME))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spectral_long_launch(
            _ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), b, na, nr, ctable,
            _block_scaled(spec.precision), _launch_operand(spec), _ptr(ex),
            stream)
    del keep, keep2, scratch, ex
    if err != 0:
        msg = lib.spectral_error_string(err).decode()
        raise RuntimeError(f"spectral_long launch failed ({err}): {msg}")
    SPECTRAL_LAUNCHES += 1
    return yr, yi


def _record(axis, fwd, inv, mode, filt, head, kara, long_fields) -> list:
    """One segment's int64 record (``_SEG_FIELDS``): axis, fwd, inv,
    mode, rank, n, n1, n2, tile, f1r, f1i, f2r, f2i, twr, twi, hr, hi,
    h_line, h_k, u, v, u_line, u_k, v_n, v_k, stw, kara, then the long
    fields (``_long_fields``; zeros for a line of one block)."""
    hr, hi, u, v, rank, h_line, h_k, u_line, u_k, v_n, v_k = filt
    n, n1, n2, tile, consts, stw = head
    rec = [axis, int(fwd), int(inv), _MODE_CODES[mode], rank, n, n1, n2,
           tile, *(_ptr(c) or 0 for c in consts), hr or 0, hi or 0,
           h_line, h_k, u or 0, v or 0, u_line, u_k, v_n, v_k,
           _ptr(stw) or 0, kara, *long_fields]
    assert len(rec) == _SEG_FIELDS
    return [int(f) for f in rec]


def _launch_cuda(spec: SpectralSpec, xr, xi, filter_args):
    global SPECTRAL_LAUNCHES
    split = check_kernel_spec(spec)
    tensors = [xr, xi, *filter_args]
    dev = xr.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA spectral kernel takes float32, "
                             f"got {t.dtype}")
    geom = long_geometry(spec)
    if geom is not None:
        return _launch_long(spec, geom, xr.contiguous(), xi.contiguous(),
                            filter_args)
    n1, n2 = split[:2]       # a filter-only op takes three factors too
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


# A dry run's record of the launches it reaches on meta tensors
# (``launch/dryrun.py``): each listener is called with (kernel name, spec,
# input plane, batch) and prices the launch; the wrappers take meta
# tensors only while one listens, and never count such a launch in
# ``SPECTRAL_LAUNCHES`` / ``MEGA_LAUNCHES``.
META_LISTENERS: list = []


def _launch_meta(kernel: str, spec, xr, xi):
    """Meta outputs of the kernel's shape, the launch told to the
    listeners; nothing runs."""
    for fn in META_LISTENERS:
        fn(kernel, spec, xr, xr.shape[0])
    return torch.empty_like(xr), torch.empty_like(xi)


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
    elif xr.device.type == "meta" and META_LISTENERS:
        check_kernel_spec(spec)
        yr, yi = _launch_meta("spectral", spec, xr, xi)
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
    launches the CUDA kernel, which takes N up to 2^21 on both FFT routes
    and every split of two or three factors on the matmul route, at every
    precision, with Karatsuba on the matmul route — lines past 4096
    points and three-factor splits as passes over device memory in the
    one launch (``long_geometry``) — and raises ValueError for anything
    else; on a CPU tensor it runs the plain version, which takes all of
    them.
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
# The libraries of the megakernels for chains with a segment past one
# block: csrc/mega_long.cu (the f32 form) and csrc/mega_long_forms.cu (the
# others), built from mega.cu beside it.
MEGA_LONG_NAME = "mega_long"
MEGA_LONG_FORMS_NAME = "mega_long_forms"
# mega.cu, mega_forms.cu, mega_long.cu and mega_long_forms.cu hold
# mega_resident; their mega_staged builds into a library of its own beside
# each (compiled side by side): staged.cu, staged_forms.cu, staged_long.cu,
# staged_long_forms.cu; and mega.cu's resident Stockham route at bs16 into
# resident_bs16.cu's.
MEGA_STAGED_NAMES = {MEGA_KERNEL_NAME: "staged",
                     MEGA_FORMS_NAME: "staged_forms",
                     MEGA_LONG_NAME: "staged_long",
                     MEGA_LONG_FORMS_NAME: "staged_long_forms"}
MEGA_RESIDENT_BS16_NAME = "resident_bs16"
# Points the resident kernel's slab may hold besides the shared-memory
# limit: what the Stockham route holds in registers at once (16 points a
# thread of 1024 for 128^2), and what the long passes' turns of the slab
# hold (32 points a thread of 512); the matmul route stages them at 512
# threads in rounds of lines, so the cut is the same on both routes.
RESIDENT_MAX_POINTS = 16384
MEGA_MAX_SEGMENTS = 8
_SEG_FIELDS = 27 + _LONG_FIELDS   # int64 fields per segment in the table
_KARA_FIELD = 26                  # the record's Karatsuba flag (``_record``)


def _resident_fits(na: int, nr: int, batch_block: int = 1) -> bool:
    """A ``batch_block``-scene split f32 slab (8 B a point) fits one
    block's opt-in shared memory and its register staging."""
    points = (batch_block or 1) * na * nr
    return points * 8 <= SMEM_OPTIN_BYTES and points <= RESIDENT_MAX_POINTS


def mega_splits(na: int, nr: int, segments, *, n1=None, n2=None, n3=None,
                fft_impl: str = "matmul") -> tuple:
    """(n, split) of every segment of a chain — ``segments`` as
    ``mega_spectral_op`` takes them, 4- or 8-field records, with the
    launch's range-axis ``n1/n2/n3`` — the split resolved as the kernels
    resolve it (``MegaSpec.seg_spec``); () for a filter-only segment and
    on the Stockham route, which splits nothing."""
    segs = tuple(SegmentSpec(axis=r[0], fwd=r[1], inv=r[2], filter_mode=r[3],
                             **dict(zip(("n1", "n2", "n3", "karatsuba"),
                                        r[4:])))
                 for r in segments)
    spec = MegaSpec(na=na, nr=nr, segments=segs, n1=n1, n2=n2, n3=n3,
                    fft_impl=fft_impl)
    return tuple(
        (spec.seg_spec(g).n,
         spec.seg_spec(g).factors() if (g.fwd or g.inv) and
         fft_impl == "matmul" else ())
        for g in segs)


def mega_residency(na: int, nr: int, batch_block: int = 1,
                   precision: Optional[str] = None,
                   filter_bytes: int = 0, splits=None) -> str:
    """The residency the compiler picks when none is pinned: ``"vmem"``
    iff a ``batch_block``-scene split f32 slab (8 B a point) fits one
    block's opt-in shared memory and its register staging, else
    ``"staged"`` (128^2, 2 x 8192, 1 x 16384 and 128^2 at the range split
    (8, 4, 4) -> vmem; 256^2 and 4096^2 -> staged), whatever the splits,
    as the reference's cut (``repro.tuning.cost.mega_residency``) is:
    ``mega_resident`` runs a line past ``TILE_MAX_N`` or a three-factor
    split as ``long_lines.cuh``'s passes on its slab. ``splits`` (the
    chain's (n, split) pairs, ``mega_splits``) is accepted and changes
    nothing.

    The Hopper counterpart of the reference's VMEM cut. The slab is f32 at
    every precision (only DFT operands narrow), and the DFT constants and
    filters are read from global memory in place, so ``precision`` is only
    validated and ``filter_bytes`` takes no shared memory; bs16's words (4
    B a (scene, line), at most 64 KiB beside a 128 KiB slab) always fit
    beside the slab."""
    resolve_precision(precision)
    del filter_bytes, splits
    fits = _resident_fits(na, nr, batch_block)
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
        lib.mega_resident_launch.argtypes = [p] * 4 + [i] * 7 + [p, p]
        lib.mega_staged_launch.argtypes = [p] * 4 + [i] * 7 + [p] * 3
        for fn in (lib.mega_resident_launch, lib.mega_staged_launch):
            fn.restype = ctypes.c_int
        if name == MEGA_STAGED_NAMES[MEGA_KERNEL_NAME]:
            lib.mega_staged_blocks_per_sm.argtypes = [ctypes.c_longlong, i]
            lib.mega_staged_blocks_per_sm.restype = ctypes.c_int
        if name == MEGA_STAGED_NAMES[MEGA_LONG_NAME]:
            lib.mega_staged_long_blocks_per_sm.argtypes = [
                ctypes.c_longlong, i]
            lib.mega_staged_long_blocks_per_sm.restype = ctypes.c_int
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
    """Raise ValueError for what the CUDA megakernels do not take: both
    take what the spectral kernel takes in every segment (a segment past
    one block runs its passes over device memory as phases of its own in
    ``mega_staged``, on the slab in ``mega_resident``, at every
    precision); ``mega_resident`` a ``batch_block``-scene slab that fits
    one block (``_resident_fits``)."""
    if len(spec.segments) > MEGA_MAX_SEGMENTS:
        raise ValueError(f"the CUDA megakernels take at most "
                         f"{MEGA_MAX_SEGMENTS} segments, got "
                         f"{len(spec.segments)}")
    for seg in spec.segments:
        if seg.fwd or seg.inv:
            check_kernel_spec(spec.seg_spec(seg))
    if spec.residency == RESIDENT_VMEM and \
            not _resident_fits(spec.na, spec.nr, spec.batch_block):
        raise ValueError(
            f"residency='vmem': a slab of {spec.batch_block or 1} "
            f"{spec.na}x{spec.nr} scene(s) does not fit one block's shared "
            f"memory ({SMEM_OPTIN_BYTES} B, {RESIDENT_MAX_POINTS} points); "
            f"use residency='staged'")


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
    # the route the launcher picks: a chain of filter-only segments with
    # bs16's codec runs the Stockham instantiation, and takes its tiles
    tile_impl = spec.fft_impl
    if not any(seg.fwd or seg.inv for seg in spec.segments) and \
            _block_scaled(spec.precision):
        tile_impl = "stockham"
    specs = [spec.seg_spec(seg) for seg in spec.segments]
    geoms = [long_geometry(sspec) for sspec in specs]
    # mega_staged: one scratch slab for every long forward-only or
    # inverse-only segment (every natural one), one set of bs16's words
    # for every long segment (each zeroes them before its reduction);
    # mega_resident runs its long passes on its slab and takes neither
    resident = spec.residency == RESIDENT_VMEM
    scratch = None
    if not resident and any(g is not None and _needs_scratch(sspec, g)
                            for g, sspec in zip(geoms, specs)):
        scratch = (torch.empty_like(xr), torch.empty_like(xi))
    ex = None
    if not resident and any(g is not None for g in geoms):
        ex = _codec_words(specs[0], b, max(spec.na, spec.nr), dev)
    for seg, sspec, geom in zip(spec.segments, specs, geoms):
        lines = spec.na if seg.axis == 1 else spec.nr
        fargs = [next(it)
                 for _ in range(_filter_ref_count(seg.filter_mode))]
        tensors, filt = _filter_launch_args(seg.filter_mode, seg.axis, fargs)
        keep += tensors
        if geom is not None:
            head, fields, consts = _long_fields(
                sspec, geom, dev,
                scratch if scratch is not None and _needs_scratch(sspec, geom)
                else None)
            keep += consts
            table.append(_record(seg.axis, seg.fwd, seg.inv,
                                 seg.filter_mode, filt, head,
                                 _karatsuba(sspec), fields))
            continue
        n1 = n2 = 1
        if seg.fwd or seg.inv:
            n1, n2 = check_kernel_spec(sspec)
        *consts, stw = _route_constants(sspec, n1, n2, dev)
        head = (sspec.n, n1, n2,
                staged_tile(sspec.n, lines, tile_impl, n1, n2, seg.axis),
                consts, stw)
        table.append(_record(seg.axis, seg.fwd, seg.inv, seg.filter_mode,
                             filt, head, _karatsuba(sspec),
                             [0] * _LONG_FIELDS))
    flat = [int(f) for rec in table for f in rec]
    assert len(flat) == _SEG_FIELDS * len(table)
    ctable = (ctypes.c_longlong * len(flat))(*flat)
    bs = _block_scaled(spec.precision)
    op = _OPERANDS[spec.precision]
    # a chain without a transform runs no stage: the f32 form (or, with
    # bs16, the Stockham route's codec: resident_bs16.cu's), in mega.cu's
    # library (mega_staged: staged.cu's); the matmul route's other forms
    # are mega_forms.cu's (mega_staged: staged_forms.cu's); a chain with a
    # segment past one block (and a resident one of batch_block > 1 scenes
    # a block) mega_long.cu's at f32 (the Stockham route's bf16 and f16
    # too; mega_staged: staged_long.cu's), else mega_long_forms.cu's
    # (staged_long_forms.cu's)
    has_fft = any(seg.fwd or seg.inv for seg in spec.segments)
    if not has_fft and not bs:
        op = 0
    forms = has_fft and spec.fft_impl == "matmul" and (
        op != 0 or any(rec[_KARA_FIELD] for rec in table))
    bb = (spec.batch_block or 1) if resident else 1
    if bb > 1 or any(g is not None for g in geoms):
        name = MEGA_LONG_FORMS_NAME if forms or bs else MEGA_LONG_NAME
    else:
        name = MEGA_FORMS_NAME if forms else MEGA_KERNEL_NAME
    if not resident:
        name = MEGA_STAGED_NAMES.get(name, name)
    elif name == MEGA_KERNEL_NAME and bs:
        name = MEGA_RESIDENT_BS16_NAME
    lib = _bind_mega(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (_ptr(xr), _ptr(xi), _ptr(yr), _ptr(yi), b, spec.na, spec.nr,
                len(table))
        if resident:
            kernel = "mega_resident"
            err = lib.mega_resident_launch(*head, bb, bs, op, ctable, stream)
        else:
            kernel = "mega_staged"
            err = lib.mega_staged_launch(*head, spec.buffer_depth, bs, op,
                                         ctable, _ptr(ex), stream)
    del keep, scratch, ex
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
    elif xr.device.type == "meta" and META_LISTENERS:
        check_mega(spec, xr.shape[0])
        check_mega_kernel(spec)
        kernel = ("mega_resident" if spec.residency == RESIDENT_VMEM
                  else "mega_staged")
        yr, yi = _launch_meta(kernel, spec, xr, xi)
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
    (at most 8 segments, both FFT routes at every precision — bs16 runs
    the codec in each segment — with Karatsuba per segment on the matmul
    route; a segment past 4096 points or of three factors runs the
    spectral kernel's long passes, over device memory in ``mega_staged``
    and on the slab in ``mega_resident``, which holds ``batch_block``
    scenes a block) and raises ValueError for anything else — including
    a forced 'vmem' on a slab that does not fit one block; on a CPU
    tensor it runs ``fft4step.mega_plain``, which takes all of them.
    """
    return _mega(xr, xi, filter_args, False, **kw)


def mega_spectral_op_plain(xr, xi, *filter_args, **kw):
    """``mega_spectral_op`` through the plain version on any device."""
    return _mega(xr, xi, filter_args, True, **kw)
