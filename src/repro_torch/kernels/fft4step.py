"""The fused spectral op's host-side pieces and its plain PyTorch version.

One fused op computes, along one axis of a batch of lines,

    [FFT]  ->  pointwise filter  ->  [IFFT]

as a four-step mixed-radix transform: N = n1 * n2 [* n3], each stage a
dense DFT-matrix contraction, a twiddle multiply between stages, and the
inverse as conj-FFT-conj with the 1/N scale folded into the final store.

This module holds what every implementation of that op shares:

* the filter modes (``FILTER_*``) and the matmul-operand precision policy;
* ``default_factorization`` / ``SpectralSpec`` / ``dft_constants`` — the
  constants are float64 math rounded to float32, element for element
  the same as the JAX package's, so the hand-written kernel and the plain
  version contract against identical matrices;
* ``stockham_twiddles`` / ``stockham_table`` — the per-pass twiddles of
  the Stockham route, one table read by the kernels and the plain
  version alike;
* the bs16 block-exponent codec (``line_exponents`` ... ``remove_exponents``);
* ``spectral_plain`` — the plain PyTorch version of the fused op: the same
  recursion as the CUDA kernel's reference design, written with
  ``torch.einsum``. It is what ``ops.spectral_op`` runs on CPU tensors and
  what ``chip_smoke.py`` holds the CUDA kernel against on the card;
* the megakernel's host side — ``SegmentSpec`` / ``MegaSpec``, the
  constants plan, the staged phase schedule — and ``mega_plain``, the
  plain version of both megakernels (a chain of per-axis segments over a
  whole ``(B, na, nr)`` slab, corner turns purely logical).

Layouts: rows (``axis=1``) transform the last axis of ``(B, lines, n)``;
cols (``axis=0``) transform the middle axis of ``(B, n, lines)``. Filters
are batch-shared and arrive in the per-axis layouts ``ops.spectral_op``
prepares (see ``_apply_filters``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

# Filter (pointwise multiply) modes of the fused op.
FILTER_NONE = "none"      # no multiply (pure FFT / pure IFFT launch)
FILTER_SHARED = "shared"  # one N-vector shared by every line (range matched filter)
FILTER_FULL = "full"      # full 2-D filter, same shape as one scene
FILTER_OUTER = "outer"    # rank-K phase exp(i * sum_k u[line,k] * v[sample,k])
FILTER_SHARED_OUTER = "shared_outer"  # H[sample] * exp(i sum_k u v)

FILTER_MODES = (FILTER_NONE, FILTER_SHARED, FILTER_FULL, FILTER_OUTER,
                FILTER_SHARED_OUTER)

MAX_FACTOR = 128  # every DFT-matrix factor is a power of two <= 128


# ---------------------------------------------------------------------------
# Precision policy
# ---------------------------------------------------------------------------
#
# Matmul-operand precision of the DFT stages. Accumulation is always
# float32; only the contraction operands are narrowed.
#
#   f32   float32 operands (default)
#   bf16  bfloat16 operands
#   f16   float16 operands (overflows past |x| ~ 6.5e4; prefer bs16)
#   bs16  block-scaled float16: one power-of-two exponent per line is
#         scaled out before the transform and folded back at the store
#
# The Stockham route has no matrix operands (``_fft_stockham`` takes no
# precision), so there bf16 and f16 are the f32 passes and bs16 is the
# exponent codec around them; the CUDA kernels take all four on both
# routes.

@dataclasses.dataclass(frozen=True)
class Precision:
    """One matmul-operand precision policy for the fused op."""

    name: str
    dtype: str            # operand dtype the DFT contractions are cast to
    block_scaled: bool    # per-line exponent extraction in prologue/epilogue

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


PRECISIONS: dict[str, Precision] = {
    "f32": Precision("f32", "float32", False),
    "bf16": Precision("bf16", "bfloat16", False),
    "f16": Precision("f16", "float16", False),
    "bs16": Precision("bs16", "float16", True),
}


def resolve_precision(p) -> Precision:
    """Accepts a Precision, a policy name, or None (-> f32)."""
    if p is None:
        return PRECISIONS["f32"]
    if isinstance(p, Precision):
        return p
    try:
        return PRECISIONS[p]
    except KeyError:
        raise ValueError(
            f"unknown precision {p!r}; one of {sorted(PRECISIONS)}") from None


def default_factorization(n: int) -> tuple[int, ...]:
    """Mixed-radix split of n into 2 or 3 power-of-two factors, each <= 128.

    n <= 128*128:  the ~sqrt two-factor split with n1 >= n2
                   (4096 = 64*64, 8192 = 128*64, 512 = 32*16).
    n <= 128^3:    three factors f1 >= f2 >= f3 (32768 = 32*32*32).
    """
    if n & (n - 1):
        raise ValueError(f"FFT length must be a power of two, got {n}")
    p = n.bit_length() - 1
    if n <= MAX_FACTOR * MAX_FACTOR:
        n1 = 1 << ((p + 1) // 2)
        return n1, n // n1
    if n > MAX_FACTOR ** 3:
        raise ValueError(
            f"n={n} exceeds the three-factor limit {MAX_FACTOR ** 3}")
    p1 = (p + 2) // 3
    p2 = (p - p1 + 1) // 2
    return 1 << p1, 1 << p2, 1 << (p - p1 - p2)


@dataclasses.dataclass(frozen=True)
class SpectralSpec:
    """Static configuration of one fused spectral op."""

    n: int                      # FFT length (the transformed axis)
    fwd: bool                   # forward FFT first?
    filter_mode: str            # FILTER_*
    inv: bool                   # inverse FFT last?
    axis: int = 1               # 1 = rows (last axis), 0 = columns
    n1: Optional[int] = None    # mixed-radix factorization override
    n2: Optional[int] = None
    n3: Optional[int] = None
    fft_impl: str = "matmul"    # 'matmul' | 'stockham'
    karatsuba: bool = False     # 3-product complex contraction instead of 4
    precision: str = "f32"      # PRECISIONS key (operands; f32 accumulate)
    outer_rank: int = 1         # K of the rank-K FILTER_OUTER phase

    def factors(self) -> tuple[int, ...]:
        """n = n1 * n2 [* n3], every factor a power of two <= 128."""
        if self.n1 is not None:
            fs = [self.n1]
            if self.n2 is not None:
                fs.append(self.n2)
            if self.n3 is not None:
                fs.append(self.n3)
            if len(fs) == 1:
                fs.append(self.n // self.n1)
            fs = tuple(fs)
        else:
            fs = default_factorization(self.n)
        if int(np.prod(fs)) != self.n:
            raise ValueError(f"factors {fs} do not multiply to n={self.n}")
        for f in fs:
            if f < 1 or f & (f - 1):
                raise ValueError(f"factor {f} is not a power of two: {fs}")
            if f > MAX_FACTOR:
                raise ValueError(
                    f"factor {f} exceeds the factor limit {MAX_FACTOR}: {fs}")
        return fs


# ---------------------------------------------------------------------------
# DFT constants (host-side numpy)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dft_constants(*factors: int) -> tuple[np.ndarray, ...]:
    """DFT matrices and inter-stage twiddles for a mixed-radix factor list.

    Returns, split re/im and in order: one (f_i, f_i) DFT matrix per
    factor, then one (f_i, prod(f_{i+1:})) twiddle per non-final stage,
    exp(-2j pi k_i j / prod(f_{i:})). float64 math rounded to float32;
    memoized per factor tuple and read-only.
    """
    def dft(n):
        k = np.arange(n)
        m = np.exp(-2j * np.pi * np.outer(k, k) / n)
        return m.real.astype(np.float32), m.imag.astype(np.float32)

    out: list[np.ndarray] = []
    for f in factors:
        out.extend(dft(f))
    for i in range(len(factors) - 1):
        rest = int(np.prod(factors[i + 1:]))
        k = np.arange(factors[i])[:, None]
        j = np.arange(rest)[None, :]
        tw = np.exp(-2j * np.pi * k * j / (factors[i] * rest))
        out.append(tw.real.astype(np.float32))
        out.append(tw.imag.astype(np.float32))
    for a in out:
        a.setflags(write=False)
    return tuple(out)


@functools.lru_cache(maxsize=64)
def device_constants(factors: tuple[int, ...],
                     device: str) -> tuple[torch.Tensor, ...]:
    """``dft_constants`` as float32 tensors on ``device`` (cached)."""
    return tuple(torch.from_numpy(np.array(c)).to(device)
                 for c in dft_constants(*factors))


def _split_consts(consts, factors):
    """(per-stage DFT matrix pairs, per-boundary twiddle pairs)."""
    k = len(factors)
    mats = [(consts[2 * i], consts[2 * i + 1]) for i in range(k)]
    tws = [(consts[2 * k + 2 * i], consts[2 * k + 2 * i + 1])
           for i in range(k - 1)]
    return mats, tws


# ---------------------------------------------------------------------------
# Complex contractions (split re/im)
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cast(x, precision: str):
    """Round the operand to the policy's dtype and back: the products of
    two narrowed operands are exact in float32, so an f32 contraction of
    the rounded values is the f32-accumulated narrow-operand product."""
    prec = PRECISIONS[precision]
    if prec.dtype == "float32":
        return x
    return x.to(prec.torch_dtype).to(torch.float32)


def _cdot(eq: str, ar, ai, br, bi, *, karatsuba: bool, precision: str):
    """Complex einsum (ar + i ai) . (br + i bi): 4 real contractions, or
    3 with Karatsuba (P3 = (Ar+Ai)(Br+Bi)). float32 accumulate."""
    ar_, ai_ = _cast(ar, precision), _cast(ai, precision)
    br_, bi_ = _cast(br, precision), _cast(bi, precision)
    if karatsuba:
        p1 = torch.einsum(eq, ar_, br_)
        p2 = torch.einsum(eq, ai_, bi_)
        p3 = torch.einsum(eq, _cast(ar + ai, precision),
                          _cast(br + bi, precision))
        return p1 - p2, p3 - p1 - p2
    yr = torch.einsum(eq, ar_, br_) - torch.einsum(eq, ai_, bi_)
    yi = torch.einsum(eq, ar_, bi_) + torch.einsum(eq, ai_, br_)
    return yr, yi


# ---------------------------------------------------------------------------
# Four-step matmul FFT (plain version)
# ---------------------------------------------------------------------------

def _fft_rows_matmul(xr, xi, consts, spec: SpectralSpec):
    """Mixed-radix four-step FFT along the last axis of (M, N): at stage
    i the length-m block is reshaped to (f_i, m/f_i), contracted with the
    f_i-point DFT matrix, twiddled, and the remainder transformed
    recursively; out[l, k_rest * f + k_i] = z[k_i, l, k_rest]."""
    factors = spec.factors()
    mats, tws = _split_consts(consts, factors)
    kw = dict(karatsuba=spec.karatsuba, precision=spec.precision)

    def rec(xr, xi, i):
        M, m = xr.shape
        f = factors[i]
        fr, fi = mats[i]
        if i == len(factors) - 1:
            # base: one dense DFT contraction (DFT matrices are symmetric)
            return _cdot("mj,jk->mk", xr, xi, fr, fi, **kw)
        rest = m // f
        x3r = xr.reshape(M, f, rest)
        x3i = xi.reshape(M, f, rest)
        # stage A: contract f with F_i -> (f, M, rest), index k_i first
        ar, ai = _cdot("kj,mjr->kmr", fr, fi, x3r, x3i, **kw)
        twr, twi = tws[i]
        br, bi = _cmul(ar, ai, twr[:, None, :], twi[:, None, :])
        zr, zi = rec(br.reshape(f * M, rest), bi.reshape(f * M, rest), i + 1)
        zr = zr.reshape(f, M, rest)
        zi = zi.reshape(f, M, rest)
        return (zr.permute(1, 2, 0).reshape(M, m),
                zi.permute(1, 2, 0).reshape(M, m))

    return rec(xr, xi, 0)


def _fft_cols_matmul(xr, xi, consts, spec: SpectralSpec):
    """The same recursion along axis 0 of an (N, C) column slab."""
    factors = spec.factors()
    mats, tws = _split_consts(consts, factors)
    kw = dict(karatsuba=spec.karatsuba, precision=spec.precision)

    def rec(xr, xi, i):
        m, C = xr.shape
        f = factors[i]
        fr, fi = mats[i]
        if i == len(factors) - 1:
            return _cdot("kj,jc->kc", fr, fi, xr, xi, **kw)
        rest = m // f
        x3r = xr.reshape(f, rest, C)
        x3i = xi.reshape(f, rest, C)
        ar, ai = _cdot("kj,jrc->krc", fr, fi, x3r, x3i, **kw)
        twr, twi = tws[i]
        br, bi = _cmul(ar, ai, twr[:, :, None], twi[:, :, None])
        cr = br.permute(1, 0, 2).reshape(rest, f * C)
        ci = bi.permute(1, 0, 2).reshape(rest, f * C)
        zr, zi = rec(cr, ci, i + 1)
        # out[k_rest * f + k_i, c] = z[k_rest, k_i, c] — a plain reshape
        return zr.reshape(m, C), zi.reshape(m, C)

    return rec(xr, xi, 0)


# ---------------------------------------------------------------------------
# Stockham FFT (plain version) and its twiddle table
# ---------------------------------------------------------------------------

def stockham_radices(n: int) -> tuple[int, ...]:
    """The pass order of the Stockham route: radix 4 while the remaining
    length divides by 4, else radix 2 (any power of two n >= 2)."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"Stockham length must be a power of two >= 2, "
                         f"got {n}")
    out = []
    while n > 1:
        radix = 4 if n % 4 == 0 else 2
        out.append(radix)
        n //= radix
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StockhamStep:
    """One exchange of the CUDA kernels' Stockham schedule: one pass, or two
    consecutive passes run on registers between two trips through shared
    memory. A group of ``G = prod(radices)`` points is what one thread
    holds in registers ``0 .. G-1``; a step has ``n // G`` groups a line.

    ``inputs[g, j]`` is the point loaded into register j of group g; with
    radices (R1, R2) (R2 = 1 for a lone pass), register ``R2 * r + r'``
    is input r of the first pass's butterfly r', which leaves its output r
    there. The second pass's butterfly t takes registers ``R2 * t ..
    R2 * t + R2 - 1`` as its inputs and leaves its outputs in place.
    ``outputs[g, j]`` is the point register j holds after the step.
    ``twiddles[i][g, b]`` is the index k into pass ``passes[i]``'s part of
    ``stockham_twiddles`` of butterfly b of group g in that pass."""

    passes: tuple[int, ...]
    radices: tuple[int, ...]
    inputs: torch.Tensor       # (n // G, G) int64
    outputs: torch.Tensor      # (n // G, G) int64
    twiddles: tuple[torch.Tensor, ...]


def stockham_pairs(n: int) -> tuple[StockhamStep, ...]:
    """The schedule ``spectral_common.cuh`` runs the Stockham passes in:
    consecutive passes paired, the last pass left alone when their count
    is odd (a radix-2 pass at N = 2, 32, 512; a radix-4 one at N = 4, 64,
    1024).

    A pass of radix R and stride s (s = 1 at the first pass, s *= R after
    each) has butterfly ``b = k * s + q`` read ``y[r * n / R + b]`` and
    write ``y[(k * R + r) * s + q]``. Two passes (R1, R2) split every
    line into n / (R1 R2) independent groups: group ``g = k' * s + q``
    reads ``{g + m * n / G}`` and writes ``{G * s * k' + q + s * m}``; in
    the last step of a transform k' = 0, so it writes the set it read.
    Where the first and last steps have the same G (N = 2, 4, 8, 16, 256,
    4096), the forward's last outputs of group g are the inverse's first
    inputs of group g: the kernels turn around in registers there."""
    rads = stockham_radices(n)
    steps = []
    p = log_s = 0
    while p < len(rads):
        pair = rads[p:p + 2]
        r1, r2 = pair[0], (pair[1] if len(pair) == 2 else 1)
        big = r1 * r2
        s = 1 << log_s
        g = torch.arange(n // big)
        kp, q = g >> log_s, g & (s - 1)
        kk = n // (big * s)                  # K': k' of one first-pass row
        j = torch.arange(big)
        t, r_out = j // r2, j % r2           # register R2 t + r''
        inputs = g[:, None] + (n // big) * j[None, :]
        outputs = (big * s * kp + q)[:, None] + s * (r1 * r_out + t)[None, :]
        twiddles = [torch.arange(r2)[None, :] * kk + kp[:, None]]
        if len(pair) == 2:
            twiddles.append(kp[:, None].expand(-1, r1).clone())
        steps.append(StockhamStep(
            passes=tuple(range(p, p + len(pair))), radices=tuple(pair),
            inputs=inputs, outputs=outputs,
            twiddles=tuple(twiddles)))
        log_s += sum(r.bit_length() - 1 for r in pair)
        p += len(pair)
    return tuple(steps)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in (lib.cosf, lib.sinf):
        fn.argtypes = [ctypes.c_float]
        fn.restype = ctypes.c_float
    return lib


@functools.lru_cache(maxsize=None)
def _stockham_host(n: int) -> tuple[tuple[torch.Tensor, ...], ...]:
    """Per-pass float32 twiddles on the host (see ``stockham_twiddles``)."""
    libm = _libm()
    passes = []
    cur = n
    for radix in stockham_radices(n):
        m = cur // radix
        th = (-2.0 * math.pi / cur) * torch.arange(m, dtype=torch.float32)
        w1r = torch.tensor([libm.cosf(t) for t in th.tolist()],
                           dtype=torch.float32)
        w1i = torch.tensor([libm.sinf(t) for t in th.tolist()],
                           dtype=torch.float32)
        if radix == 4:
            w2r, w2i = _cmul(w1r, w1i, w1r, w1i)
            w3r, w3i = _cmul(w2r, w2i, w1r, w1i)
            passes.append((w1r, w1i, w2r, w2i, w3r, w3i))
        else:
            passes.append((w1r, w1i))
        cur = m
    return tuple(passes)


@functools.lru_cache(maxsize=64)
def stockham_twiddles(n: int, device: str) -> tuple:
    """The twiddles of each Stockham pass of an n-point FFT, on ``device``
    (cached per ``(n, device)``): a radix-4 pass of remaining length c
    holds ``(w1r, w1i, w2r, w2i, w3r, w3i)``, each (c/4,), with
    w1 = e^{-2 pi i k / c}, w2 = w1 * w1, w3 = w2 * w1; a radix-2 pass
    ``(w1r, w1i)``, each (c/2,).

    The JAX package's kernel computes the same float32 formula in place:
    theta = (-2 pi / c) * k in float32, cos/sin, then the products through
    ``_cmul``. Its float32 cos/sin run, on the CPU, as the C library's
    ``cosf`` / ``sinf``, so the table takes them from there (torch.cos and
    torch.sin differ from them in the last bit for c >= 16) and builds it
    once on the host; every device gets the same numbers."""
    return tuple(tuple(t.to(device) for t in p) for p in _stockham_host(n))


@functools.lru_cache(maxsize=64)
def stockham_table(n: int, device: str) -> torch.Tensor:
    """``stockham_twiddles`` flattened for the CUDA kernels: float32 pairs
    (re, im), pass after pass; a radix-4 pass holds (w1, w2, w3) for k = 0,
    1, ..., a radix-2 pass w1 for k = 0, 1, ...."""
    parts = []
    for p in _stockham_host(n):
        pairs = [torch.stack(p[i:i + 2], dim=1) for i in range(0, len(p), 2)]
        parts.append(torch.stack(pairs, dim=1).reshape(-1))
    return torch.cat(parts).to(device)


def _fft_stockham(xr, xi, axis: int):
    """Self-sorting radix-4/radix-2 Stockham FFT along `axis` of a 2-D
    block, elementwise ops only (the paper's scalar baseline); twiddles
    from ``stockham_twiddles``, the table the CUDA kernels read."""
    if axis == 0:
        yr, yi = _fft_stockham(xr.T, xi.T, 1)
        return yr.T, yi.T
    L, N = xr.shape
    yr = xr.reshape(L, N, 1)
    yi = xi.reshape(L, N, 1)
    n, s = N, 1
    for radix, tw in zip(stockham_radices(N),
                         stockham_twiddles(N, str(xr.device))):
        m = n // radix
        w1r, w1i = tw[0][:, None], tw[1][:, None]
        sl = lambda z, q: z[:, q * m:(q + 1) * m, :]  # noqa: E731
        if radix == 4:
            w2r, w2i = tw[2][:, None], tw[3][:, None]
            w3r, w3i = tw[4][:, None], tw[5][:, None]
            a_r, a_i = sl(yr, 0), sl(yi, 0)
            b_r, b_i = sl(yr, 1), sl(yi, 1)
            c_r, c_i = sl(yr, 2), sl(yi, 2)
            d_r, d_i = sl(yr, 3), sl(yi, 3)
            apc_r, apc_i = a_r + c_r, a_i + c_i
            amc_r, amc_i = a_r - c_r, a_i - c_i
            bpd_r, bpd_i = b_r + d_r, b_i + d_i
            bmd_r, bmd_i = b_r - d_r, b_i - d_i
            t0r, t0i = apc_r + bpd_r, apc_i + bpd_i
            t1r, t1i = _cmul(amc_r + bmd_i, amc_i - bmd_r, w1r, w1i)
            t2r, t2i = _cmul(apc_r - bpd_r, apc_i - bpd_i, w2r, w2i)
            t3r, t3i = _cmul(amc_r - bmd_i, amc_i + bmd_r, w3r, w3i)
            outs_r, outs_i = [t0r, t1r, t2r, t3r], [t0i, t1i, t2i, t3i]
        else:
            a_r, a_i = sl(yr, 0), sl(yi, 0)
            b_r, b_i = sl(yr, 1), sl(yi, 1)
            t1r, t1i = _cmul(a_r - b_r, a_i - b_i, w1r, w1i)
            outs_r, outs_i = [a_r + b_r, t1r], [a_i + b_i, t1i]
        yr = torch.stack(outs_r, dim=2).reshape(L, m, radix * s)
        yi = torch.stack(outs_i, dim=2).reshape(L, m, radix * s)
        n, s = m, radix * s
    return yr.reshape(L, N), yi.reshape(L, N)


def _run_fft(xr, xi, consts, spec: SpectralSpec, inverse: bool):
    """Forward or inverse (conj-FFT-conj, x 1/N) transform along
    spec.axis of a (B, L, n) / (B, n, L) batch: the batch folds into
    the line dim (scenes are independent lines)."""
    b = xr.shape[0]
    if spec.axis == 1:
        xr2 = xr.reshape(b * xr.shape[1], xr.shape[2])
        xi2 = xi.reshape(b * xi.shape[1], xi.shape[2])
    else:
        xr2 = xr.movedim(0, 1).reshape(xr.shape[1], b * xr.shape[2])
        xi2 = xi.movedim(0, 1).reshape(xi.shape[1], b * xi.shape[2])
    if inverse:
        xi2 = -xi2
    if spec.fft_impl == "matmul":
        fft = _fft_rows_matmul if spec.axis == 1 else _fft_cols_matmul
        yr, yi = fft(xr2, xi2, consts, spec)
    elif spec.fft_impl == "stockham":
        yr, yi = _fft_stockham(xr2, xi2, spec.axis)
    else:
        raise ValueError(f"unknown fft_impl {spec.fft_impl}")
    if inverse:
        scale = 1.0 / spec.n
        yr, yi = yr * scale, yi * (-scale)
    if spec.axis == 1:
        return yr.reshape(xr.shape), yi.reshape(xi.shape)
    yr = yr.reshape(xr.shape[1], b, xr.shape[2]).movedim(1, 0)
    yi = yi.reshape(xi.shape[1], b, xi.shape[2]).movedim(1, 0)
    return yr, yi


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as the kernels' ``__fmaf_rn``,
    on any device: the product is exact in float64, the sum is rounded to
    odd there (TwoSum gives its error), which makes the last rounding, to
    float32, the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)            # s + err == p + c exactly
    inexact = err != 0
    bits = s.view(torch.int64)
    bits = bits - (inexact & ((err > 0) != (s > 0))).long()  # toward zero
    return (bits | inexact.long()).view(torch.float64).float()


def outer_phase(u, v, axis: int):
    """The rank-K phase ``sum_q u[line, q] v[k, q]`` of the outer filter in
    the per-axis layouts (rows: u (L, K), v (K, n) -> (L, n); cols:
    u (K, L), v (n, K) -> (n, L)), rounded as the kernels round it:
    ``ph = fma(u_q, v_q, ph)`` from 0, q in order. (A matrix product sums
    in an order its library picks by shape, 1 ulp off the kernels at some
    shapes.)"""
    rank = u.shape[1] if axis == 1 else u.shape[0]
    ph = None
    for q in range(rank):
        a, b = (u[:, q, None], v[None, q, :]) if axis == 1 \
            else (v[:, q, None], u[None, q, :])
        if ph is None:
            ph = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                             dtype=torch.float32, device=u.device)
        ph = fma32(a, b, ph)
    return ph


def _apply_filters(xr, xi, axis: int, filter_mode: str, filt):
    """Apply one composed filter to a (B, L, n) / (B, n, L) batch.

    ``filt`` holds the mode's tensors in the per-axis layouts:
      shared:       hr, hi  (1, n) rows / (n, 1) cols
      full:         hr, hi  (L, n) rows / (n, L) cols
      outer:        u, v    (L, K), (K, n) rows / (K, L), (n, K) cols
      shared_outer: hr, hi, u, v — the shared vector first, then the phase
    2-D payloads broadcast over the leading batch dim."""

    def _apply_outer(xr, xi, u, v):
        phase = outer_phase(u, v, axis)
        return _cmul(xr, xi, torch.cos(phase), torch.sin(phase))

    if filter_mode in (FILTER_SHARED, FILTER_FULL):
        xr, xi = _cmul(xr, xi, filt[0], filt[1])
    elif filter_mode == FILTER_OUTER:
        xr, xi = _apply_outer(xr, xi, filt[0], filt[1])
    elif filter_mode == FILTER_SHARED_OUTER:
        xr, xi = _cmul(xr, xi, filt[0], filt[1])
        xr, xi = _apply_outer(xr, xi, filt[2], filt[3])
    return xr, xi


# ---------------------------------------------------------------------------
# bs16 block-exponent codec
# ---------------------------------------------------------------------------

def line_exponents(xr, xi, axis: int):
    """One power-of-two exponent per line, reduced over the transform axis
    (the last dim when axis=1, the second-to-last when axis=0):
    ceil(log2(max(amax, 1e-37))), clamped to [-126, 126]. The 1e-37 floor
    keeps all-zero lines finite (and the argument a normal float); the
    clamp keeps ``_pow2`` exact for both exp and -exp.

    The ceil-log2 is read from the float32 bits — the exponent field, plus
    one unless the mantissa is zero — so it is exact, and the CUDA
    kernels compute the same integer ops (``spectral_common.cuh::
    line_exponent``). A float32 ``log2`` rounds to the integer below just
    above a power of two (log2(2^k (1 + 2^-23)) -> k for k >= 4), where
    the exact ceil is k + 1."""
    red = xr.ndim - 1 if axis == 1 else xr.ndim - 2
    amax = torch.maximum(xr.abs().amax(dim=red, keepdim=True),
                         xi.abs().amax(dim=red, keepdim=True))
    floor = torch.tensor(1e-37, dtype=torch.float32, device=xr.device)
    bits = torch.maximum(amax, floor).view(torch.int32)
    exp = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return torch.clamp(exp, -126, 126).to(torch.float32)


def _pow2(exp):
    """Exactly 2^exp for integer-valued float32 exp in [-126, 126], built
    by placing exp into the float32 exponent bits (never exp2, which is
    not exact on every backend)."""
    bits = (exp.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def apply_exponents(xr, xi, exp):
    """Fold per-line exponents back in (exact)."""
    scale = _pow2(exp)
    return xr * scale, xi * scale


def remove_exponents(xr, xi, exp):
    """Scale per-line exponents out (exact): x -> x * 2^-exp."""
    inv = _pow2(-exp)
    return xr * inv, xi * inv


# ---------------------------------------------------------------------------
# The plain version of the fused op
# ---------------------------------------------------------------------------

def spectral_plain(spec: SpectralSpec, xr, xi, *filt):
    """[FFT] -> filter -> [IFFT] on (B, lines, n) / (B, n, lines) float32
    tensors, with ``filt`` in the per-axis layouts of ``_apply_filters``.
    Runs on whatever device the tensors are on."""
    consts = None
    if spec.fft_impl == "matmul" and (spec.fwd or spec.inv):
        consts = device_constants(spec.factors(), str(xr.device))
    exp = None
    if PRECISIONS[spec.precision].block_scaled:
        exp = line_exponents(xr, xi, spec.axis)
        xr, xi = remove_exponents(xr, xi, exp)
    if spec.fwd:
        xr, xi = _run_fft(xr, xi, consts, spec, inverse=False)
    xr, xi = _apply_filters(xr, xi, spec.axis, spec.filter_mode, filt)
    if spec.inv:
        xr, xi = _run_fft(xr, xi, consts, spec, inverse=True)
    if exp is not None:
        xr, xi = apply_exponents(xr, xi, exp)
    return xr.contiguous(), xi.contiguous()


def flops_nominal(spec: SpectralSpec, lines: int, batch: int = 1) -> float:
    """Nominal 5 N log2 N per transform + 6N per complex multiply."""
    n = spec.n
    f = 0.0
    if spec.fwd:
        f += 5.0 * n * math.log2(max(n, 2))
    if spec.inv:
        f += 5.0 * n * math.log2(max(n, 2))
    if spec.filter_mode != FILTER_NONE:
        f += 6.0 * n
    return f * lines * batch


# ---------------------------------------------------------------------------
# The single-dispatch 2-D megakernel: fft? mul* ifft? (turn fft? mul* ifft?)*
# ---------------------------------------------------------------------------
#
# One launch runs a sequence of per-axis segments over a (B, na, nr)
# scene, with the corner turns between them inside the kernel, in one of
# two residency modes (the reference's strings, so that one set of
# compile options drives both packages):
#
# RESIDENT_VMEM   the whole scene slab stays on chip for the whole call —
#                 on Hopper, in one CTA's shared memory (csrc/mega.cu
#                 ``mega_resident``); a turn is purely logical.
# RESIDENT_STAGED one phase per segment; each phase strips its free axis
#                 into tiles of whole lines, and the corner-turned
#                 intermediate lives in device memory (csrc/mega.cu
#                 ``mega_staged``, a persistent cooperative kernel with a
#                 grid-wide barrier between phases).
#
# Both run the same per-segment math as the per-axis op, and every segment
# treats its lines independently, so f32 results are the same in both
# modes and in the equivalent chain of per-axis launches. bs16 re-blocks
# its per-line exponents at every segment boundary (``mega_plain``).

RESIDENT_VMEM = "vmem"      # whole slab on chip (Hopper: shared memory)
RESIDENT_STAGED = "staged"  # phase-split, device-memory intermediate


def _filter_ref_count(filter_mode: str) -> int:
    """Operand count of one kernel filter payload, by mode."""
    return {FILTER_NONE: 0, FILTER_SHARED: 2, FILTER_FULL: 2,
            FILTER_OUTER: 2, FILTER_SHARED_OUTER: 4}[filter_mode]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """One per-axis ``fft? mul* ifft?`` run inside a megakernel launch.
    ``n1/n2/n3`` and ``karatsuba`` pin this segment's factorization and
    complex-product algorithm; ``None`` defers to the MegaSpec."""

    axis: int                      # 1 = range/rows, 0 = azimuth/cols
    fwd: bool = False
    inv: bool = False
    filter_mode: str = FILTER_NONE
    outer_rank: int = 1
    n1: Optional[int] = None
    n2: Optional[int] = None
    n3: Optional[int] = None
    karatsuba: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class MegaSpec:
    """Static configuration of one single-launch 2-D megakernel."""

    na: int                        # azimuth lines (axis-0 FFT length)
    nr: int                        # range samples (axis-1 FFT length)
    segments: tuple[SegmentSpec, ...]
    residency: str = RESIDENT_VMEM
    batch_block: Optional[int] = None  # scenes per resident slab (None = 1)
    phase_block: int = 8           # staged: the phase's line granule
    buffer_depth: int = 2          # staged: prefetch slots (1 = none)
    n1: Optional[int] = None       # range-axis factorization override
    n2: Optional[int] = None       #   (azimuth uses default_factorization)
    n3: Optional[int] = None
    fft_impl: str = "matmul"
    karatsuba: bool = False
    precision: str = "f32"

    def __post_init__(self):
        if not self.segments:
            raise ValueError("MegaSpec needs at least one segment")
        if self.residency not in (RESIDENT_VMEM, RESIDENT_STAGED):
            raise ValueError(f"unknown residency {self.residency!r}")
        if self.buffer_depth < 1:
            raise ValueError(
                f"buffer_depth must be >= 1, got {self.buffer_depth}")
        for s in self.segments:
            if s.axis not in (0, 1):
                raise ValueError(f"segment axis must be 0 or 1, got {s.axis}")
            if not (s.fwd or s.inv or s.filter_mode != FILTER_NONE):
                raise ValueError("empty megakernel segment")
        resolve_precision(self.precision)

    def seg_spec(self, seg: SegmentSpec) -> SpectralSpec:
        """The per-axis SpectralSpec view of one segment. Factorization:
        the segment's own override > the MegaSpec range-axis knobs (axis 1
        only) > library default; karatsuba: segment > MegaSpec."""
        kw = {}
        if seg.axis == 1:
            kw = dict(n1=self.n1, n2=self.n2, n3=self.n3)
        if seg.n1 is not None:
            kw = dict(n1=seg.n1, n2=seg.n2, n3=seg.n3)
        kara = self.karatsuba if seg.karatsuba is None else seg.karatsuba
        return SpectralSpec(
            n=self.nr if seg.axis == 1 else self.na,
            fwd=seg.fwd, inv=seg.inv, filter_mode=seg.filter_mode,
            axis=seg.axis, fft_impl=self.fft_impl, karatsuba=kara,
            precision=self.precision, outer_rank=seg.outer_rank, **kw)

    @property
    def turns(self) -> int:
        """In-kernel corner turns (axis changes between segments)."""
        return sum(1 for a, b in zip(self.segments, self.segments[1:])
                   if a.axis != b.axis)


def _seg_const_key(spec: MegaSpec, seg: SegmentSpec) -> tuple:
    """(axis, factorization): segments share one constants set only while
    they agree on both."""
    return (seg.axis, spec.seg_spec(seg).factors())


def _mega_const_plan(spec: MegaSpec) -> list[tuple[tuple, tuple]]:
    """((axis, factors), dft_constants) per distinct transformed
    (axis, factorization), in first-use order."""
    out: list[tuple[tuple, tuple]] = []
    if spec.fft_impl != "matmul":
        return out
    seen = set()
    for seg in spec.segments:
        key = _seg_const_key(spec, seg)
        if (seg.fwd or seg.inv) and key not in seen:
            seen.add(key)
            out.append((key, dft_constants(*key[1])))
    return out


def _seg_filter_shapes(spec: MegaSpec, seg: SegmentSpec) -> list[tuple]:
    """Kernel-layout shapes of one segment's filter operands (whole-scene;
    filters are never line-blocked)."""
    na, nr, K = spec.na, spec.nr, seg.outer_rank
    if seg.axis == 1:
        shared, full = (1, nr), (na, nr)
        u, v = (na, K), (K, nr)
    else:
        shared, full = (na, 1), (na, nr)
        u, v = (K, nr), (na, K)
    return {
        FILTER_NONE: [],
        FILTER_SHARED: [shared, shared],
        FILTER_FULL: [full, full],
        FILTER_OUTER: [u, v],
        FILTER_SHARED_OUTER: [shared, shared, u, v],
    }[seg.filter_mode]


def _staged_phases(spec: MegaSpec) -> tuple[list[dict], int]:
    """The staged schedule: one phase per segment, its free axis stripped
    in ``phase_block``-line blocks. Returns (phases, total blocks). Phase
    p reads the input (p = 0) or the intermediate and writes the
    intermediate or the output (last p). Raises ValueError when
    ``phase_block`` does not divide a free axis."""
    phases: list[dict] = []
    off = 0
    last = len(spec.segments) - 1
    for i, seg in enumerate(spec.segments):
        lines = spec.na if seg.axis == 1 else spec.nr
        pb = min(spec.phase_block, lines)
        if lines % pb:
            raise ValueError(
                f"phase_block={pb} does not divide the free axis "
                f"({lines} lines) of segment {i}")
        phases.append(dict(
            seg=seg, idx=i, axis=seg.axis, pb=pb, nblocks=lines // pb,
            offset=off, src="x" if i == 0 else "scratch",
            dst="out" if i == last else "scratch"))
        off += lines // pb
    return phases, off


def _mega_flops(spec: MegaSpec) -> float:
    """Nominal FLOP of one scene through every segment (5 N log2 N per
    transform + 6 N per multiply, per line)."""
    total = 0.0
    for seg in spec.segments:
        lines = spec.na if seg.axis == 1 else spec.nr
        total += flops_nominal(spec.seg_spec(seg), lines)
    return total


def check_mega(spec: MegaSpec, batch: int) -> None:
    """The residency's own shape rules, on every route: a resident
    ``batch_block`` divides the batch; a staged ``phase_block`` divides
    every free axis."""
    if spec.residency == RESIDENT_VMEM:
        bb = spec.batch_block or 1
        if batch % bb:
            raise ValueError(
                f"batch={batch} not divisible by batch_block={bb}")
    else:
        _staged_phases(spec)


def _run_segment(xr, xi, consts, sspec: SpectralSpec, seg: SegmentSpec,
                 filt):
    """One segment on a (B, na, nr) slab — the rows layout (B, L, n) and
    the cols layout (B, n, L) are both the scene layout, so the corner
    turn between segments is purely logical."""
    if seg.fwd:
        xr, xi = _run_fft(xr, xi, consts, sspec, inverse=False)
    xr, xi = _apply_filters(xr, xi, seg.axis, seg.filter_mode, filt)
    if seg.inv:
        xr, xi = _run_fft(xr, xi, consts, sspec, inverse=True)
    return xr, xi


def mega_plain(spec: MegaSpec, xr, xi, *filter_args):
    """The plain version of both megakernels: the segment chain over the
    whole (B, na, nr) float32 slab, with ``filter_args`` per segment in
    the kernel layouts of ``_seg_filter_shapes``. Every precision,
    ``karatsuba`` and ``fft_impl``; runs on the tensors' device.

    bs16 extracts per-line exponents along the first segment's free axis,
    and at every later segment boundary applies the carried exponents
    (exact) and re-extracts along the new segment's free axis; the
    exponents land once, at the end."""
    check_mega(spec, xr.shape[0])
    dev = str(xr.device)
    consts = {key: device_constants(key[1], dev)
              for key, _ in _mega_const_plan(spec)}
    it = iter(filter_args)
    seg_filts = [tuple(next(it)
                       for _ in range(_filter_ref_count(s.filter_mode)))
                 for s in spec.segments]
    block_scaled = PRECISIONS[spec.precision].block_scaled
    exp = None
    for i, (seg, filt) in enumerate(zip(spec.segments, seg_filts)):
        if block_scaled:
            if i:
                xr, xi = apply_exponents(xr, xi, exp)
            exp = line_exponents(xr, xi, seg.axis)
            xr, xi = remove_exponents(xr, xi, exp)
        xr, xi = _run_segment(xr, xi, consts.get(_seg_const_key(spec, seg)),
                              spec.seg_spec(seg), seg, filt)
    if exp is not None:
        xr, xi = apply_exponents(xr, xi, exp)
    return xr.contiguous(), xi.contiguous()
