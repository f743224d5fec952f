"""Point-target quality metrics: PSLR, ISLR, SNR (paper Table IV).

All metrics are computed host-side with numpy on the magnitude image — they
are validation instruments, not part of the compute pipeline. Pass images
as numpy arrays (``tensor.cpu().numpy()``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sar.geometry import PointTarget, SceneConfig


@dataclasses.dataclass
class TargetReport:
    row: int                 # measured peak position (azimuth)
    col: int                 # measured peak position (range)
    peak: float              # |peak|
    snr_db: float            # 20 log10(|peak| / noise RMS)
    pslr_range_db: float     # peak sidelobe ratio along the range cut
    pslr_azimuth_db: float
    islr_range_db: float     # integrated sidelobe ratio along the range cut
    islr_azimuth_db: float


def expected_pixel(cfg: SceneConfig, tgt: PointTarget) -> tuple[int, int]:
    """Predicted (row, col) of a focused target.

    Range: the echo starts at fast time 2R/c; the matched filter (replica at
    offset 0) compresses to the start sample. Azimuth: closest approach time.
    """
    col = cfg.nr / 2 + tgt.range_offset / cfg.dr
    row = cfg.na / 2 + tgt.azimuth_offset / cfg.da
    return int(round(row)) % cfg.na, int(round(col)) % cfg.nr


def _find_peak(mag: np.ndarray, row: int, col: int, search: int = 8):
    """Local peak within +-search of the predicted position (wrapped)."""
    na, nr = mag.shape
    rows = (np.arange(row - search, row + search + 1)) % na
    cols = (np.arange(col - search, col + search + 1)) % nr
    win = mag[np.ix_(rows, cols)]
    i, j = np.unravel_index(np.argmax(win), win.shape)
    return int(rows[i]), int(cols[j])


def _cut_metrics(cut: np.ndarray, peak_idx: int, mainlobe_halfwidth: int,
                 window: int):
    """PSLR and ISLR along a 1-D cut around peak_idx."""
    n = len(cut)
    idx = (np.arange(peak_idx - window, peak_idx + window + 1)) % n
    seg = np.abs(cut[idx]) ** 2
    center = window  # peak position within seg
    main = np.zeros(len(seg), bool)
    main[center - mainlobe_halfwidth:center + mainlobe_halfwidth + 1] = True
    p_main = float(seg[main].sum())
    p_side = float(seg[~main].sum())
    peak_side = float(seg[~main].max()) if (~main).any() else 0.0
    peak_main = float(seg[center])
    pslr = 10.0 * np.log10(max(peak_side, 1e-30) / peak_main)
    islr = 10.0 * np.log10(max(p_side, 1e-30) / max(p_main, 1e-30))
    return pslr, islr


def noise_rms(image: np.ndarray, cfg: SceneConfig,
              targets: list[PointTarget], guard: int = 64) -> float:
    """RMS magnitude outside guard windows around every target."""
    mag = np.abs(image)
    mask = np.ones_like(mag, bool)
    for t in targets:
        r, c = expected_pixel(cfg, t)
        rows = (np.arange(r - guard, r + guard + 1)) % cfg.na
        cols = (np.arange(c - guard, c + guard + 1)) % cfg.nr
        mask[np.ix_(rows, cols)] = False
    vals = mag[mask]
    return float(np.sqrt(np.mean(vals**2))) if vals.size else 0.0


def analyze_target(image: np.ndarray, cfg: SceneConfig, tgt: PointTarget,
                   noise: float, mainlobe_cells: float = 1.5,
                   window: int = 32) -> TargetReport:
    mag = np.abs(image)
    r0, c0 = expected_pixel(cfg, tgt)
    r, c = _find_peak(mag, r0, c0)
    # mainlobe halfwidth in samples from the theoretical resolutions
    ml_r = max(2, int(round(mainlobe_cells * cfg.range_res / cfg.dr)))
    ml_a = max(2, int(round(mainlobe_cells * cfg.azimuth_res / cfg.da)))
    rng_cut = image[r, :]
    azi_cut = image[:, c]
    pslr_r, islr_r = _cut_metrics(rng_cut, c, ml_r, window)
    pslr_a, islr_a = _cut_metrics(azi_cut, r, ml_a, window)
    peak = float(mag[r, c])
    snr = 20.0 * np.log10(peak / max(noise, 1e-30))
    return TargetReport(r, c, peak, snr, pslr_r, pslr_a, islr_r, islr_a)


def analyze_scene(image: np.ndarray, cfg: SceneConfig,
                  targets: list[PointTarget]) -> list[TargetReport]:
    noise = noise_rms(image, cfg, targets)
    return [analyze_target(image, cfg, t, noise) for t in targets]


# ---------------------------------------------------------------------------
# Pipeline-vs-pipeline comparisons (paper Table IV top rows)
# ---------------------------------------------------------------------------

def l2_relative_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel()) /
                 max(np.linalg.norm(b.ravel()), 1e-30))


def max_abs_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b)))


def compare_pipelines(img_a: np.ndarray, img_b: np.ndarray, cfg: SceneConfig,
                      targets: list[PointTarget]) -> dict:
    """The paper's Table IV: L2 rel error, max abs error, per-target SNR
    for both images and the per-target SNR delta."""
    rep_a = analyze_scene(img_a, cfg, targets)
    rep_b = analyze_scene(img_b, cfg, targets)
    return {
        "l2_relative_error": l2_relative_error(img_a, img_b),
        "max_abs_error": max_abs_error(img_a, img_b),
        "snr_a_db": [r.snr_db for r in rep_a],
        "snr_b_db": [r.snr_db for r in rep_b],
        "snr_delta_db": [abs(x.snr_db - y.snr_db)
                         for x, y in zip(rep_a, rep_b)],
        "reports_a": rep_a,
        "reports_b": rep_b,
    }
