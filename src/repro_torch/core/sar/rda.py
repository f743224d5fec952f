"""Range Doppler Algorithm — every variant is a SpectralPlan (paper Sec. IV).

The variants are data: declarative ``SpectralPlan`` stage lists
(core/plan.py) compiled into launches of the fused spectral op. Data
layout: (na, nr) = (azimuth, range), complex64 at the public boundary,
split re/im float32 inside the launches. A compiled pipeline takes one
scene (na, nr) or a batch (B, na, nr) sharing the SceneConfig.

Variants
--------
``unfused``      The paper's baseline: one torch.fft op per atom (FFT,
                 multiply, IFFT, ...) and the 8-tap sinc RCMC.
                 7 dispatches.
``fused``        Paper-faithful fusion (Sec. IV-A): range compression as
                 ONE launch (FFT * H_r * IFFT), the azimuth FFT as
                 transpose -> row FFT -> transpose, RCMC the separate
                 8-tap sinc step, azimuth compression as transpose ->
                 row H_a * IFFT -> transpose. 8 launches: 3 of the
                 spectral kernel, 4 of the tiled transpose kernel, and
                 the sinc RCMC in plain PyTorch ops.
``fused_tfree``  Column launches transform azimuth in place, RCMC is a
                 fused Fourier-shift launch, azimuth compression a fused
                 column launch. 4 launches, no global transposes.
``fused3``       Range compression commutes with the azimuth FFT, so the
                 plan reorders to azimuth FFT -> [range FFT * H_r *
                 RCMC-shift * IFFT] -> [H_a * azimuth IFFT]. 3 launches.
``fused1``       The same stage list as ``fused3``, fused across the axis
                 changes (``fuse="mega"``): ONE megakernel launch with the
                 corner turns inside — shared-memory resident for scenes
                 that fit one block (128^2), grid-staged through device
                 memory beyond (the paper's 4096^2). 1 launch.

Every variant compiles with ``fft_impl="matmul"`` (the four-step
DFT-matrix stages, the default) or ``fft_impl="stockham"`` (the paper's
scalar radix-4/radix-2 Stockham baseline), in the same launch counts.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.plan import (  # noqa: F401  (re-exported)
    Pipeline,
    SpectralPlan,
    Stage,
    Step,
    split,
    unsplit,
)
from repro_torch.core.sar import filters
from repro_torch.core.sar.geometry import SceneConfig


# ---------------------------------------------------------------------------
# Sinc-interpolation RCMC (the one non-spectral stage kind the RDA uses)
# ---------------------------------------------------------------------------

def rcmc_sinc(x: torch.Tensor, cfg: SceneConfig, taps: int = 8,
              range_variant: bool = False, lo: Optional[int] = None,
              hi: Optional[int] = None) -> torch.Tensor:
    """8-tap windowed-sinc RCMC in the range-Doppler domain (paper step 3).

    x: (na, nr) or (B, na, nr) complex, rows = Doppler bins. Row f_a is
    shifted by -s(f_a) samples, y[..., row, col] = x[..., row, col + s]
    interpolated (the shift table broadcasts across any batch dim).
    lo/hi restrict the shift table to a row strip (the streaming executor,
    ``Pipeline.run_streamed``); x then holds rows lo..hi only.
    """
    dev = x.device
    if range_variant:
        s_np = filters.rcmc_shift_samples_variant(cfg)
    else:
        s_np = filters.rcmc_shift_samples(cfg)[:, None]
    if lo is not None:
        s_np = s_np[lo:hi]
    s = torch.as_tensor(s_np, dtype=torch.float32, device=dev)
    base = torch.floor(s)
    frac = s - base  # in [0, 1)
    cols = torch.arange(cfg.nr, dtype=torch.int64, device=dev)[None, :]
    y = torch.zeros_like(x)
    offs = np.arange(taps) - taps // 2 + 1
    # weights: sinc(k - frac) * hamming, normalized (matches filters.sinc_…)
    xk = torch.as_tensor(offs, dtype=torch.float32,
                         device=dev)[None, None, :] - frac[..., None]
    w = torch.sinc(xk) * torch.where(
        torch.abs(xk) <= taps // 2,
        0.54 + 0.46 * torch.cos(torch.pi * xk / (taps // 2)),
        torch.zeros_like(xk))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    base_i = base.to(torch.int64)
    for k in range(taps):
        idx = torch.remainder(cols + base_i + int(offs[k]), cfg.nr)
        gathered = torch.gather(x, -1, idx.expand(x.shape))
        y = y + gathered * w[..., k].to(x.dtype)
    return y


def _sinc_rcmc_impl(x, cfg, opts, lo, hi):
    return rcmc_sinc(x, cfg, taps=opts.get("taps", 8),
                     range_variant=opts.get("range_variant", False),
                     lo=lo, hi=hi)


planlib.register_stage_impl("sinc_rcmc", _sinc_rcmc_impl, stream_axis=0)


# ---------------------------------------------------------------------------
# The RDA plans
# ---------------------------------------------------------------------------

def plan_unfused(rcmc_mode: str = "sinc") -> SpectralPlan:
    """The textbook 4-step RDA. rcmc_mode 'sinc' uses the 8-tap windowed
    sinc interpolator; 'fourier' the exact shift-theorem correction."""
    if rcmc_mode == "sinc":
        rcmc = Stage("rcmc", kind="sinc_rcmc")
    elif rcmc_mode == "fourier":
        rcmc = Stage("rcmc", axis=1, fwd=True, inv=True,
                     filters=("rcmc_shift",))
    else:
        raise ValueError(f"unknown rcmc_mode {rcmc_mode!r}")
    return SpectralPlan("unfused", (
        Stage("range_compression", axis=1, fwd=True, inv=True,
              filters=("range_mf",)),
        Stage("azimuth_fft", axis=0, fwd=True),
        rcmc,
        Stage("azimuth_compression", axis=0, inv=True,
              filters=("azimuth_mf",)),
    ))


def plan_fused() -> SpectralPlan:
    """The paper's pipeline (Sec. IV-A): steps 1 & 4 fused, the azimuth
    transform via global transposes, RCMC a separate sinc step."""
    return SpectralPlan("fused", (
        Stage("range_compression", axis=1, fwd=True, inv=True,
              filters=("range_mf",)),
        Stage("azimuth_fft_turn_in", kind="transpose"),
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("azimuth_fft_turn_out", kind="transpose"),
        Stage("rcmc", kind="sinc_rcmc"),
        Stage("azimuth_compression_turn_in", kind="transpose"),
        Stage("azimuth_compression", axis=0, inv=True,
              filters=("azimuth_mf",)),
        Stage("azimuth_compression_turn_out", kind="transpose"),
    ))


def plan_fused_tfree(synth_phase: bool = False) -> SpectralPlan:
    """4 launches, no global transposes, RCMC fused via the shift theorem.

    synth_phase=False reads the exact precomputed 2-D azimuth filter
    (FILTER_FULL); True synthesizes it on chip as a float32-safe rank-2
    phase (FILTER_OUTER), removing the filter's device-memory read."""
    az = "azimuth_mf_outer" if synth_phase else "azimuth_mf"
    return SpectralPlan("fused_tfree", (
        Stage("range_compression", axis=1, fwd=True, inv=True,
              filters=("range_mf",)),
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("rcmc", axis=1, fwd=True, inv=True, filters=("rcmc_shift",)),
        Stage("azimuth_compression", axis=0, inv=True, filters=(az,)),
    ))


def plan_fused3(synth_phase: bool = True) -> SpectralPlan:
    """The minimum-launch per-axis RDA: azimuth FFT -> [range FFT * H_r *
    RCMC-shift * IFFT] -> [H_a * azimuth IFFT]. The compiler fuses H_r
    (shared) with the RCMC rank-1 phase (outer) into ONE shared_outer
    launch."""
    az = "azimuth_mf_outer" if synth_phase else "azimuth_mf"
    return SpectralPlan("fused3", (
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("range_comp_rcmc", axis=1, fwd=True, inv=True,
              filters=("range_mf", "rcmc_shift")),
        Stage("azimuth_compression", axis=0, inv=True, filters=(az,)),
    ))


def plan_fused1(synth_phase: bool = True) -> SpectralPlan:
    """The single-launch RDA: the SAME stage list as ``fused3``, compiled
    under the cross-axis grammar (``fuse="mega"``) — the azimuth FFT, the
    fused range stage and the azimuth compression become segments of ONE
    megakernel launch with the corner turns inside the kernel."""
    az = "azimuth_mf_outer" if synth_phase else "azimuth_mf"
    return SpectralPlan("fused1", (
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("range_comp_rcmc", axis=1, fwd=True, inv=True,
              filters=("range_mf", "rcmc_shift")),
        Stage("azimuth_compression", axis=0, inv=True, filters=(az,)),
    ))


planlib.register_variant(
    "unfused", plan_unfused,
    compile_defaults=(("backend", planlib.BACKEND_TORCH), ("fuse", False)),
    plan_kw=("rcmc_mode",), dispatches=7)
planlib.register_variant(
    "fused", plan_fused, dispatches=8)
planlib.register_variant(
    "fused_tfree", plan_fused_tfree, plan_kw=("synth_phase",), dispatches=4)
planlib.register_variant(
    "fused3", plan_fused3, plan_kw=("synth_phase",), dispatches=3)
planlib.register_variant(
    "fused1", plan_fused1,
    compile_defaults=(("fuse", planlib.FUSE_MEGA),),
    plan_kw=("synth_phase",), dispatches=1)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def build_pipeline(cfg: SceneConfig, variant: str, **kw) -> Pipeline:
    """Compile a registered pipeline variant for one scene geometry.

    kw: plan kwargs (rcmc_mode / synth_phase, per variant) plus any
    compile_plan option (device, block, col_block, fft_impl, precision,
    backend, fuse, residency, phase_block, buffer_depth, batch_block,
    batch, tune, fft_kw, schedule; ``tune="cached"`` by default).
    ``device=None`` (the default) runs on the CUDA card and raises without
    one; pass ``device="cpu"`` for the plain version."""
    return planlib.build_variant(cfg, variant, **kw)


def focus(raw, cfg: SceneConfig, variant: str = "fused_tfree",
          **kw) -> torch.Tensor:
    """One-call focusing: raw echo (na, nr) — or a batch (B, na, nr) of
    scenes sharing `cfg` — complex64 -> focused image(s) of the same
    shape, on the pipeline's device (see :func:`build_pipeline`)."""
    return build_pipeline(cfg, variant, **kw).run(raw)


def documented_dispatches(variant: str) -> int:
    """The variant's documented compiled dispatch count."""
    return planlib.get_variant(variant).dispatches


def variant_names() -> tuple[str, ...]:
    return planlib.variant_names()


def _build(variant: str, cfg: SceneConfig, **kw) -> Pipeline:
    return build_pipeline(cfg, variant, **kw)


BUILDERS: dict[str, Callable[..., Pipeline]] = {
    v: functools.partial(_build, v)
    for v in ("unfused", "fused", "fused_tfree", "fused3", "fused1")
}
