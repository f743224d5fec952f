"""SAR scene geometry and derived radar quantities.

Side-looking strip-map geometry per Cumming & Wong [1]: a platform moving at
velocity ``v`` along azimuth, transmitting linear-FM chirps (bandwidth ``B``,
duration ``tp``, carrier ``fc``) toward a scene at closest-approach range
``r0``. The paper's scene is 4096 x 4096 complex samples (azimuth x range),
X-band (fc = 10 GHz), B = 100 MHz, v = 100 m/s, r0 = 20 km, 20 dB noise.
"""
from __future__ import annotations

import dataclasses
import math

C = 299_792_458.0  # speed of light, m/s


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Static description of one SAR acquisition + simulation grid."""

    na: int = 4096            # azimuth lines
    nr: int = 4096            # range samples per line
    fc: float = 10.0e9        # carrier frequency (Hz)  — X band
    bandwidth: float = 100.0e6  # chirp bandwidth (Hz)
    tp: float = 10.0e-6       # pulse duration (s)
    fs: float = 120.0e6       # range sampling rate (Hz), 1.2x oversampled
    prf: float = 400.0        # pulse repetition frequency (Hz)
    v: float = 100.0          # platform velocity (m/s)
    r0: float = 20_000.0      # closest-approach range of scene center (m)
    aperture_time: float = 4.0  # synthetic aperture (beam dwell) time (s)
    noise_db: float = 20.0    # raw-data SNR in dB (paper: 20 dB additive noise)
    seed: int = 1234

    # ---- derived quantities -------------------------------------------------
    @property
    def wavelength(self) -> float:
        return C / self.fc

    @property
    def kr(self) -> float:
        """Range chirp FM rate (Hz/s)."""
        return self.bandwidth / self.tp

    @property
    def ka(self) -> float:
        """Azimuth FM rate at scene center (Hz/s), hyperbolic approximation."""
        return 2.0 * self.v**2 / (self.wavelength * self.r0)

    @property
    def doppler_bandwidth(self) -> float:
        return self.ka * self.aperture_time

    @property
    def range_res(self) -> float:
        """Slant-range resolution c/2B (m)."""
        return C / (2.0 * self.bandwidth)

    @property
    def azimuth_res(self) -> float:
        return self.v / self.doppler_bandwidth

    @property
    def dr(self) -> float:
        """Range sample spacing (m)."""
        return C / (2.0 * self.fs)

    @property
    def da(self) -> float:
        """Azimuth sample spacing (m)."""
        return self.v / self.prf

    @property
    def pulse_samples(self) -> int:
        return int(round(self.tp * self.fs))

    @property
    def aperture_samples(self) -> int:
        return int(round(self.aperture_time * self.prf))

    def validate(self) -> None:
        if self.doppler_bandwidth >= self.prf:
            raise ValueError(
                f"azimuth aliasing: doppler bandwidth {self.doppler_bandwidth:.1f} Hz"
                f" >= PRF {self.prf:.1f} Hz")
        if self.bandwidth > self.fs:
            raise ValueError("range aliasing: bandwidth > fs")
        if self.pulse_samples >= self.nr:
            raise ValueError("pulse longer than range window")
        if self.aperture_samples >= self.na:
            raise ValueError("aperture longer than azimuth window")


@dataclasses.dataclass(frozen=True)
class PointTarget:
    """A point scatterer at (range_offset_m, azimuth_offset_m) from scene
    center, with complex reflectivity magnitude ``sigma``."""

    range_offset: float = 0.0     # m, + = farther
    azimuth_offset: float = 0.0   # m, + = later
    sigma: float = 1.0


def paper_scene(na: int = 4096, nr: int = 4096) -> SceneConfig:
    """The paper's experimental setup (Sec. V-A)."""
    return SceneConfig(na=na, nr=nr)


def paper_targets(cfg: SceneConfig) -> list[PointTarget]:
    """Five point targets at various range/azimuth offsets (paper Table IV)."""
    rs = cfg.dr * cfg.nr / 8          # range extent unit
    az = cfg.da * cfg.na / 8          # azimuth extent unit
    return [
        PointTarget(0.0, 0.0),                      # target 0: center
        PointTarget(rs, 0.0),                       # target 1: range offset
        PointTarget(0.0, az),                       # target 2: azimuth offset
        PointTarget(-rs, -az),                      # target 3: diagonal offset
        PointTarget(2 * rs, 1.5 * az),              # target 4: far offset
    ]


def scene_from_dict(d: dict) -> SceneConfig:
    """A SceneConfig from ``dataclasses.asdict`` of one (this package's or
    the JAX package's — the fields are the same)."""
    fields = {f.name for f in dataclasses.fields(SceneConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown SceneConfig fields {sorted(unknown)}")
    return SceneConfig(**d)


def test_scene(n: int = 512) -> SceneConfig:
    """A reduced scene with the same qualitative regime (for CPU tests).

    Parameters are rescaled so the pulse fills ~1/4 of the range window and
    the aperture ~5/8 of the azimuth window, with visible range migration.
    """
    fs = 120.0e6
    prf = 400.0
    return SceneConfig(
        na=n,
        nr=n,
        fs=fs,
        prf=prf,
        tp=(n // 4) / fs,
        aperture_time=(n * 5 // 8) / prf,
        r0=5_000.0,
        noise_db=20.0,
    )
