"""Matched filters and RCMC terms for the Range Doppler Algorithm.

All filters are host-side numpy (float64 math where it matters), returned
as split re/im float32 (the kernel's native layout); ``*_c`` variants
return complex64 for the ``torch`` backend. Phases are computed
with the bulk carrier term removed (exp(i*4*pi*fc*r0/c) is constant per range
gate and does not affect focusing) so float32 trigonometry stays accurate.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.sar.geometry import C, SceneConfig


# ---------------------------------------------------------------------------
# Axes
# ---------------------------------------------------------------------------

def range_freqs(cfg: SceneConfig) -> np.ndarray:
    """Range (fast-time) frequency axis, FFT ordering (Hz)."""
    return np.fft.fftfreq(cfg.nr, d=1.0 / cfg.fs)


def azimuth_freqs(cfg: SceneConfig) -> np.ndarray:
    """Azimuth (Doppler) frequency axis, FFT ordering (Hz). Broadside
    geometry => Doppler centroid 0, no fftshift needed."""
    return np.fft.fftfreq(cfg.na, d=1.0 / cfg.prf)


def migration_factor(cfg: SceneConfig) -> np.ndarray:
    """D(f_a) = sqrt(1 - (lambda f_a / 2 v)^2), (na,) float64."""
    fa = azimuth_freqs(cfg)
    s = (cfg.wavelength * fa / (2.0 * cfg.v)) ** 2
    return np.sqrt(np.maximum(1.0 - s, 1e-12))


def range_gates(cfg: SceneConfig) -> np.ndarray:
    """Closest-approach range r0(col) of each range gate (m), (nr,) float64."""
    return cfg.r0 + (np.arange(cfg.nr) - cfg.nr / 2) * cfg.dr


# ---------------------------------------------------------------------------
# Range matched filter (step 1 of the RDA)
# ---------------------------------------------------------------------------

def range_matched_filter(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """H_r(f) = conj(FFT(chirp replica)), split re/im float32, (nr,).

    The replica is the transmitted chirp placed at fast-time offset 0, so the
    compressed peak lands at the echo's start column.
    """
    n = cfg.pulse_samples
    t = np.arange(n, dtype=np.float64) / cfg.fs
    replica = np.zeros(cfg.nr, np.complex128)
    replica[:n] = np.exp(1j * np.pi * cfg.kr * t**2)
    h = np.conj(np.fft.fft(replica))
    return h.real.astype(np.float32), h.imag.astype(np.float32)


def range_matched_filter_c(cfg: SceneConfig) -> np.ndarray:
    hr, hi = range_matched_filter(cfg)
    return (hr + 1j * hi).astype(np.complex64)


# ---------------------------------------------------------------------------
# RCMC (step 3)
# ---------------------------------------------------------------------------

def rcmc_shift_samples(cfg: SceneConfig) -> np.ndarray:
    """Range-invariant RCMC shift (in range samples) per Doppler row, (na,).

    delta_R(f_a) = r0 (1/D - 1), evaluated at the scene-center range (the
    paper's narrow-swath approximation).
    """
    d = migration_factor(cfg)
    return (cfg.r0 * (1.0 / d - 1.0) / cfg.dr).astype(np.float64)


def rcmc_shift_samples_variant(cfg: SceneConfig) -> np.ndarray:
    """Range-VARIANT shift (na, nr): delta_R(f_a, r) = r0(r)(1/D - 1)/dr."""
    d = migration_factor(cfg)[:, None]
    r = range_gates(cfg)[None, :]
    return r * (1.0 / d - 1.0) / cfg.dr


def rcmc_phase_uv(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """Rank-1 phase parameters for the fused Fourier-shift RCMC.

    After a range FFT of the range-Doppler data, multiplying row f_a by
    exp(+i 2 pi k s(f_a) / nr) (k = FFT bin index, signed) shifts its content
    by -s samples, i.e. x_corr[col] = x[col + s]. Returns (u (na,), v (nr,))
    with phase = u[row] * v[col].
    """
    u = rcmc_shift_samples(cfg).astype(np.float32)
    v = (2.0 * np.pi * np.fft.fftfreq(cfg.nr)).astype(np.float32)
    return u, v


def sinc_interp_weights(frac: np.ndarray, taps: int = 8) -> np.ndarray:
    """Windowed-sinc interpolation weights, (len(frac), taps).

    Tap k (k = 0..taps-1) samples position floor(s) + k - taps//2 + 1; the
    weight is sinc(k - taps//2 + 1 - frac) * hamming window (the paper's
    8-tap sinc interpolator)."""
    offs = np.arange(taps) - taps // 2 + 1
    x = offs[None, :] - frac[:, None]
    w = np.sinc(x)
    ham = 0.54 + 0.46 * np.cos(np.pi * x / (taps // 2))
    w = w * np.where(np.abs(x) <= taps // 2, ham, 0.0)
    # normalize so DC gain is exactly 1
    return (w / np.sum(w, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# Azimuth matched filter (step 4)
# ---------------------------------------------------------------------------

def azimuth_phase_uv(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """Rank-1 azimuth-compression phase: H_a = exp(i u[col] v[row]).

    Exact hyperbolic filter with the bulk carrier removed:
      phase(f_a, r) = (4 pi fc / c) * r0(r) * (D(f_a) - 1)
    which factors as u[r] = r0(r) (meters), v[f_a] = 4 pi fc (D-1) / c.
    """
    u = range_gates(cfg).astype(np.float32)
    v = (4.0 * np.pi * cfg.fc * (migration_factor(cfg) - 1.0) / C).astype(np.float32)
    return u, v


def azimuth_phase_uv2(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """Rank-2, float32-safe factorization of the azimuth-compression phase.

    The raw rank-1 product r0(r) * v(f_a) reaches ~10^3..10^4 radians, where
    float32 cos/sin loses ~1e-4 of phase. Splitting off the scene-center bulk
    term and wrapping it mod 2 pi in float64 keeps every float32 factor small:

      phase(f_a, r) = (r0(r) - r_ref) * v(f_a)  +  wrap(r_ref * v(f_a))

    Returns u (nr, 2), v (na, 2) for the FILTER_OUTER rank-K kernel
    (phase = sum_k u[col,k] * v[row,k])."""
    d = migration_factor(cfg)
    v1 = 4.0 * np.pi * cfg.fc * (d - 1.0) / C                  # (na,) f64
    rg = range_gates(cfg)                                       # (nr,) f64
    u = np.stack([rg - cfg.r0, np.ones_like(rg)], axis=1)
    wrapped = np.angle(np.exp(1j * (cfg.r0 * v1)))              # mod 2pi, f64
    v = np.stack([v1, wrapped], axis=1)
    return u.astype(np.float32), v.astype(np.float32)


def azimuth_matched_filter_c(cfg: SceneConfig) -> np.ndarray:
    """Full 2-D azimuth filter H_a(f_a, r), complex64 (na, nr) — the unfused
    baseline's explicit filter (and the fused FILTER_FULL variant's input)."""
    u, v = azimuth_phase_uv(cfg)
    phase = v[:, None].astype(np.float64) * u[None, :].astype(np.float64)
    return np.exp(1j * phase).astype(np.complex64)


def azimuth_matched_filter_split(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    h = azimuth_matched_filter_c(cfg)
    return h.real.astype(np.float32), h.imag.astype(np.float32)


# ---------------------------------------------------------------------------
# ω-K (range migration) terms
# ---------------------------------------------------------------------------

def range_freqs_unwrapped(cfg: SceneConfig) -> np.ndarray:
    """Range frequency axis unwrapped to [0, fs), (nr,) float64.

    The demodulated chirp is one-sided (instantaneous frequency sweeps
    0..B with B possibly beyond fs/2), so DFT bin b physically carries
    frequency (b/nr)·fs — NOT the signed fftfreq value. The ω-K dispersion
    sqrt((fc+f_r)² − …) must be evaluated on this unwrapped axis to
    compensate the right physical frequency per bin."""
    return np.arange(cfg.nr, dtype=np.float64) / cfg.nr * cfg.fs


def omegak_kmap(cfg: SceneConfig) -> np.ndarray:
    """K(f_a, f_r) = sqrt((fc+f_r)² − (c f_a / 2v)²), (na, nr) float64 —
    the 2-D wavenumber the ω-K reference function is built from."""
    fr = range_freqs_unwrapped(cfg)[None, :]
    fa = azimuth_freqs(cfg)[:, None]
    arg = (cfg.fc + fr) ** 2 - (C * fa / (2.0 * cfg.v)) ** 2
    return np.sqrt(np.maximum(arg, 1.0))


def omegak_stolt_phase(cfg: SceneConfig, r_ref: Optional[float] = None) -> np.ndarray:
    """Differential ω-K reference-function phase, complex64 (na, nr):

        H(f_a, f_r) = exp(+i 4π r_ref/c · (K(f_a,f_r) − fc − f_r))

    K − fc − f_r vanishes identically at f_a = 0, so this filter is exactly
    the *migration* part of the reference function: multiplied with the
    range matched filter it compensates bulk RCM and azimuth hyperbolic
    phase at r_ref through ALL orders of f_r (the paper-fused RDA only
    corrects the f_r-linear shift). Its own f_r-linear content is the
    fused Fourier-shift stage of the Stolt map — the first-order Stolt
    interpolation exp(i 2π f_r Δt(f_a)) applied in the same dispatch as
    the range FFT/IFFT pair, leaving only the range-variant residual
    (r − r_ref)(1/D − 1) that the RDA narrow-swath approximation also
    accepts. Computed float64, wrapped mod 2π, stored complex64."""
    r_ref = cfg.r0 if r_ref is None else r_ref
    fr = range_freqs_unwrapped(cfg)[None, :]
    k = omegak_kmap(cfg)
    phase = (4.0 * np.pi * r_ref / C) * (k - cfg.fc - fr)
    return np.exp(1j * np.mod(phase, 2.0 * np.pi)).astype(np.complex64)


def stolt_azimuth_uv(cfg: SceneConfig, r_ref: Optional[float] = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Residual ω-K azimuth compression, rank-1 phase for FILTER_OUTER:

        phase(f_a, r) = 4π fc (D(f_a) − 1) (r0(r) − r_ref) / c

    The bulk term at r_ref is already inside omegak_stolt_phase, so unlike
    the RDA rank-2 filter no wrapped-bulk column is needed; the residual
    factors are small enough for float32. u: (nr,) per range gate,
    v: (na,) per Doppler bin."""
    r_ref = cfg.r0 if r_ref is None else r_ref
    u = (range_gates(cfg) - r_ref).astype(np.float32)
    v = (4.0 * np.pi * cfg.fc * (migration_factor(cfg) - 1.0) / C
         ).astype(np.float32)
    return u, v


# ---------------------------------------------------------------------------
# SpectralPlan filter registry — the names plans reference
# ---------------------------------------------------------------------------

def _register_plan_filters() -> None:
    from repro_torch.core import plan
    from repro_torch.kernels.fft4step import (
        FILTER_FULL,
        FILTER_OUTER,
        FILTER_SHARED,
    )

    plan.register_filter(
        "range_mf", FILTER_SHARED,
        lambda cfg, p: range_matched_filter_c(cfg))
    plan.register_filter(
        "azimuth_mf", FILTER_FULL,
        lambda cfg, p: azimuth_matched_filter_c(cfg))
    plan.register_filter(
        "azimuth_mf_outer", FILTER_OUTER,
        lambda cfg, p: azimuth_phase_uv2(cfg))
    plan.register_filter(
        "rcmc_shift", FILTER_OUTER,
        lambda cfg, p: rcmc_phase_uv(cfg))
    plan.register_filter(
        "omegak_stolt", FILTER_FULL,
        lambda cfg, p: omegak_stolt_phase(cfg, p.get("r_ref")))
    plan.register_filter(
        "stolt_az", FILTER_OUTER,
        lambda cfg, p: stolt_azimuth_uv(cfg, p.get("r_ref")))


_register_plan_filters()
