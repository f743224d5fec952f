"""Chirp Scaling Algorithm as a SpectralPlan (Raney et al. 1994; C&W ch. 7).

CSA trades RCMC interpolation for three phase multiplies (chirp scaling
-> bulk RCMC + range compression in the 2-D spectrum -> azimuth
compression + residual phase), so it is FFT-and-multiply only, and ONE
stage list serves every variant:

``csa``         compiled with the ``torch`` backend unfused: the textbook
                CSA, one ``torch.fft`` op per atom (4 transforms, 3
                multiplies). 7 dispatches — the baseline, as the JAX
                package's XLA one.
``csa_fused``   the kernel backend fuses the filter-only chirp-scaling
                stage into the azimuth FFT: 3 launches of the spectral
                kernel, no transposes,

                  1. cols: FFT_az -> * H1            (FILTER_FULL)
                  2. rows: FFT_r  -> * H2 -> IFFT_r  (FILTER_FULL)
                  3. cols:        -> * H3 -> IFFT_az (FILTER_FULL)
``csa_fused1``  the same stage list under the megakernel grammar: ONE
                launch, the three screens read as FULL filters.

Every screen is a whole (na, nr) complex screen, built once per (cfg,
plan) on the host in float64 (the compiler's filter cache) and moved to
the device once; a compiled pipeline takes one scene (na, nr) or a batch
(B, na, nr) sharing the SceneConfig. ``fft_impl`` and ``precision`` are
compile options of every variant, as for the RDA.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from repro_torch.core import plan as planlib
from repro_torch.core.plan import Pipeline, SpectralPlan, Stage
from repro_torch.core.sar import filters
from repro_torch.core.sar.geometry import C, SceneConfig
from repro_torch.kernels.fft4step import FILTER_FULL


def _csa_terms(cfg: SceneConfig, r_ref: Optional[float] = None):
    """Host-side (float64) CSA phase terms, all in FFT ordering:

      cs      (na,)  curvature factor Cs(f_a) = 1/D - 1
      km      (na,)  range FM rate modified by range-azimuth coupling
      tau_ref (na,)  reference delay 2 R_ref / (c D)
      tau     (nr,)  absolute fast-time axis
      fr      (nr,)  range frequency axis
    """
    r_ref = cfg.r0 if r_ref is None else r_ref
    d = filters.migration_factor(cfg)                      # (na,)
    cs = 1.0 / d - 1.0
    fa = filters.azimuth_freqs(cfg)
    km = cfg.kr / (1.0 - cfg.kr * C * r_ref * fa**2 /
                   (2.0 * cfg.v**2 * cfg.fc**3 * d**3))
    tau_ref = 2.0 * r_ref / (C * d)
    t0 = 2.0 * cfg.r0 / C
    tau = t0 + (np.arange(cfg.nr) - cfg.nr / 2) / cfg.fs
    fr = filters.range_freqs(cfg)
    return dict(r_ref=r_ref, d=d, cs=cs, km=km, tau_ref=tau_ref, tau=tau,
                fr=fr, fa=fa)


def csa_phases(cfg: SceneConfig, r_ref: Optional[float] = None):
    """The three CSA phase screens, complex64 (na, nr), computed in float64
    and wrapped mod 2 pi before the cast:

    h1: chirp scaling            exp(+i pi Km Cs (tau - tau_ref)^2)
    h2: range compression + bulk RCMC over (f_a, f_r):
        exp(+i pi D f_r^2 / Km) * exp(+i 4 pi f_r R_ref Cs / c)
    h3: azimuth MF (bulk-removed) + residual phase:
        exp(+i 4 pi fc r0 (D-1) / c) * exp(-i 4 pi Km (1+Cs) Cs
                                            (r0 - R_ref)^2 / c^2)
    """
    t = _csa_terms(cfg, r_ref)
    cs, km, tau_ref = t["cs"][:, None], t["km"][:, None], t["tau_ref"][:, None]
    d = t["d"][:, None]
    tau, fr = t["tau"][None, :], t["fr"][None, :]

    ph1 = np.pi * km * cs * (tau - tau_ref) ** 2
    h1 = np.exp(1j * np.mod(ph1, 2 * np.pi)).astype(np.complex64)

    ph2 = np.pi * d * fr**2 / km + 4.0 * np.pi * fr * t["r_ref"] * cs / C
    h2 = np.exp(1j * np.mod(ph2, 2 * np.pi)).astype(np.complex64)

    r0_gate = filters.range_gates(cfg)[None, :]
    ph3 = (4.0 * np.pi * cfg.fc * (d - 1.0) / C) * r0_gate \
        - 4.0 * np.pi * km * (1.0 + cs) * cs * (r0_gate - t["r_ref"]) ** 2 / C**2
    h3 = np.exp(1j * np.mod(ph3, 2 * np.pi)).astype(np.complex64)
    return h1, h2, h3


# The three screens are computed together and each filter takes its own:
# the last scene's three are kept (the same arrays the plan's filter
# cache holds), so building all three costs one csa_phases, not three.
_last_phases = functools.lru_cache(maxsize=1)(csa_phases)

planlib.register_filter(
    "csa_h1", FILTER_FULL,
    lambda cfg, p: _last_phases(cfg, p.get("r_ref"))[0])
planlib.register_filter(
    "csa_h2", FILTER_FULL,
    lambda cfg, p: _last_phases(cfg, p.get("r_ref"))[1])
planlib.register_filter(
    "csa_h3", FILTER_FULL,
    lambda cfg, p: _last_phases(cfg, p.get("r_ref"))[2])


def plan_csa(r_ref: Optional[float] = None) -> SpectralPlan:
    """One stage list for every CSA variant (see the module docstring)."""
    params = () if r_ref is None else (("r_ref", float(r_ref)),)
    return SpectralPlan("csa", (
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("chirp_scaling", axis=0, filters=("csa_h1",)),
        Stage("range_comp_rcmc", axis=1, fwd=True, inv=True,
              filters=("csa_h2",)),
        Stage("azimuth_compression", axis=0, inv=True, filters=("csa_h3",)),
    ), params=params)


planlib.register_variant(
    "csa", plan_csa,
    compile_defaults=(("backend", planlib.BACKEND_TORCH), ("fuse", False)),
    plan_kw=("r_ref",), dispatches=7)
planlib.register_variant(
    "csa_fused", plan_csa, plan_kw=("r_ref",), dispatches=3)
planlib.register_variant(
    "csa_fused1", plan_csa,
    compile_defaults=(("fuse", planlib.FUSE_MEGA),),
    plan_kw=("r_ref",), dispatches=1)


def build_csa(cfg: SceneConfig, r_ref: Optional[float] = None,
              **kw) -> Pipeline:
    """Unfused CSA: 4 FFT stages + 3 phase multiplies, one torch op each."""
    return planlib.build_variant(cfg, "csa", r_ref=r_ref, **kw)


def build_csa_fused(cfg: SceneConfig, r_ref: Optional[float] = None,
                    **kw) -> Pipeline:
    """CSA through the fused spectral kernel: 3 launches, no transposes."""
    return planlib.build_variant(cfg, "csa_fused", r_ref=r_ref, **kw)
