"""The reduced-precision quality gate, measured in-library (the port's copy
of the JAX package's ``repro.tuning.quality``).

Narrow matmul operands run the tensor cores at several times the f32
(3xTF32) rate — but the GATE, not the throughput, decides admissibility.
The tuner (search.py) calls :func:`precision_snr_deviation`; on the card it
focuses the scene through the matmul route's bf16 / f16 / bs16 kernels.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def gate_scene(n: int):
    """The n^2 scene the gate focuses: the reduced ``test_scene(n)`` where
    its geometry holds (up to 1024^2), the paper's geometry at n^2 where
    the reduced one would alias in azimuth (2048^2 and up)."""
    from repro_torch.core.sar.geometry import paper_scene, test_scene
    cfg = test_scene(n)
    try:
        cfg.validate()
    except ValueError:
        return paper_scene(n, n)
    return cfg


@functools.lru_cache(maxsize=None)
def precision_snr_deviation(precision: str, n: int = 256,
                            variant: str = "fused3",
                            device: Optional[str] = None,
                            fft_impl: str = "matmul") -> float:
    """Max per-target SNR deviation (dB) of focusing the 5-point-target
    scene (``gate_scene(n)``) with ``precision`` matmul operands vs f32,
    both on ``device`` (None: the card) through ``variant`` on the
    ``fft_impl`` route (the compile default, the four-step matmul route);
    ``inf`` where the image is not finite (an f16 operand past 65504: a
    coherent line's partial sums at N = 4096 reach it even behind bs16's
    per-line exponents). Measured once per argument tuple per process
    (lru_cache)."""
    if precision in (None, "f32"):
        return 0.0
    from repro_torch.core.sar import (   # deferred: quality -> sar -> plan
        build_pipeline,
        metrics,
        paper_targets,
        simulate,
    )
    cfg = gate_scene(n)
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets, device=device)
    kw = dict(tune="off", device=device, fft_impl=fft_impl)
    base = build_pipeline(cfg, variant, **kw).run(raw).cpu().numpy()
    img = build_pipeline(cfg, variant, precision=precision,
                         **kw).run(raw).cpu().numpy()
    if not np.isfinite(img).all():
        return float("inf")
    c = metrics.compare_pipelines(np.asarray(img), np.asarray(base), cfg,
                                  targets)
    return float(max(c["snr_delta_db"]))
