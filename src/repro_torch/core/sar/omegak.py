"""omega-K (range-migration) algorithm as a SpectralPlan (Cumming & Wong
ch. 8, first-order Stolt): only a plan, compiled by the shared compiler.

  1. azimuth FFT                                        (cols launch)
  2. range FFT -> H_mf(f_r) * H_stolt(f_a, f_r) -> range IFFT
                                                        (rows launch)
  3. residual azimuth compression * azimuth IFFT        (cols launch)

The compiler composes the shared range matched filter with the 2-D Stolt
phase (``filters.omegak_stolt_phase``) into ONE FULL screen for stage 2;
stage 3 is the rank-1 OUTER phase ``filters.stolt_azimuth_uv``, built on
chip. The neglected warp term leaves the residual RCM (r - r_ref)(1/D - 1),
so the peaks sit within a pixel of the RDA's.

``omegak``         3 launches of the spectral kernel.
``omegak_fused1``  the same stage list under the megakernel grammar: ONE
                   launch, the Stolt screen read as a FULL filter.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import plan as planlib
from repro_torch.core.plan import SpectralPlan, Stage


def plan_omegak(r_ref: Optional[float] = None) -> SpectralPlan:
    """The omega-K plan. r_ref: Stolt reference range (default: the scene
    center)."""
    params = () if r_ref is None else (("r_ref", float(r_ref)),)
    return SpectralPlan("omegak", (
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("range_rfm_stolt", axis=1, fwd=True, inv=True,
              filters=("range_mf", "omegak_stolt")),
        Stage("azimuth_compression", axis=0, inv=True, filters=("stolt_az",)),
    ), params=params)


planlib.register_variant(
    "omegak", plan_omegak, plan_kw=("r_ref",), dispatches=3)
planlib.register_variant(
    "omegak_fused1", plan_omegak,
    compile_defaults=(("fuse", planlib.FUSE_MEGA),),
    plan_kw=("r_ref",), dispatches=1)
