"""Chirp-signal point-target raw-echo simulator (paper Sec. V-A).

Generates the demodulated baseband echo matrix (na x nr, complex64) for a
set of point targets under the hyperbolic range equation

    R_k(eta) = sqrt(r0_k^2 + v^2 (eta - eta_k)^2),

with a linear-FM transmitted chirp and rectangular range/azimuth windows,
plus additive circular Gaussian noise at the configured raw SNR.

The echo is computed in float64 on the device and stored complex64. The
noise comes from a ``torch.Generator`` seeded by ``cfg.seed``: it has the
JAX package's distribution, not its bits, so parity checks compare the
noise-free echo or feed one scene to both packages.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.sar.geometry import C, PointTarget, SceneConfig


def time_axes(cfg: SceneConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(slow_time (na,), fast_time (nr,)) float64, centered on the scene."""
    eta = (torch.arange(cfg.na, dtype=torch.float64, device=device)
           - cfg.na / 2) / cfg.prf
    t0 = 2.0 * cfg.r0 / C
    t = t0 + (torch.arange(cfg.nr, dtype=torch.float64, device=device)
              - cfg.nr / 2) / cfg.fs
    return eta, t


def _target_echo(cfg: SceneConfig, eta, t, tgt: PointTarget) -> torch.Tensor:
    """Echo of one point target on the (na, nr) grid, complex64."""
    r0k = cfg.r0 + tgt.range_offset
    etak = tgt.azimuth_offset / cfg.v
    rk = torch.sqrt(r0k**2 + (cfg.v * (eta - etak)) ** 2)[:, None]
    tau = 2.0 * rk / C                       # two-way delay
    dt = t[None, :] - tau                    # fast time relative to echo start
    w_r = (torch.abs(dt - cfg.tp / 2) <= cfg.tp / 2).to(torch.float64)
    w_a = (torch.abs(eta - etak) <= cfg.aperture_time / 2).to(
        torch.float64)[:, None]
    phase = -2.0 * math.pi * cfg.fc * tau + math.pi * cfg.kr * dt**2
    echo = torch.polar(tgt.sigma * w_r * w_a, phase)
    return echo.to(torch.complex64)


def simulate(cfg: SceneConfig, targets: list[PointTarget],
             add_noise: bool = True, device=None) -> torch.Tensor:
    """Raw echo matrix (na, nr) complex64 on ``device`` (default: the
    CUDA card; raises without one) for all targets, plus noise."""
    cfg.validate()
    dev = resolve_device(device)
    eta, t = time_axes(cfg, dev)
    acc = torch.zeros((cfg.na, cfg.nr), dtype=torch.complex64, device=dev)
    for tgt in targets:
        acc = acc + _target_echo(cfg, eta, t, tgt)
    if add_noise and cfg.noise_db is not None:
        # raw per-sample echo power within the support is sigma^2
        snr_lin = 10.0 ** (cfg.noise_db / 10.0)
        sigma_n = float(np.sqrt(1.0 / (2.0 * snr_lin)))
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        nr_ = torch.randn(acc.shape, generator=gen, dtype=torch.float32,
                          device=dev)
        ni_ = torch.randn(acc.shape, generator=gen, dtype=torch.float32,
                          device=dev)
        acc = acc + torch.complex(nr_, ni_) * sigma_n
    return acc


@functools.lru_cache(maxsize=4)
def _cached_scene_np(cfg: SceneConfig, targets: tuple[PointTarget, ...],
                     add_noise: bool, device: str) -> np.ndarray:
    return simulate(cfg, list(targets), add_noise, device).cpu().numpy()


def simulate_cached(cfg: SceneConfig, targets: list[PointTarget],
                    add_noise: bool = True,
                    device: Optional[str] = None) -> np.ndarray:
    """Host-cached simulator (tests reuse the same scene repeatedly);
    computed on ``device``, returned as a numpy array."""
    return _cached_scene_np(cfg, tuple(targets), add_noise,
                            str(resolve_device(device)))
