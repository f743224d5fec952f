"""repro_torch.tuning — the single owner of kernel-config decisions, as
in the JAX package's ``repro.tuning`` (the same names, types, cache schema
and search logic), measuring the port's CUDA kernels:

* :mod:`repro_torch.tuning.space`  — :class:`TuneKey` (problem shape +
  torch device type and fingerprint, batch normalized to serving buckets)
  and :class:`KernelConfig` / :class:`Schedule`.
* :mod:`repro_torch.tuning.cost`   — the H100 cost model ranking
  candidates without running them (tensor-core stages, bytes, the
  kernels' own feasibility cut).
* :mod:`repro_torch.tuning.search` — cost-ordered measured search with
  successive-halving early stopping and the SNR quality gate.
* :mod:`repro_torch.tuning.cache`  — versioned schema-validated JSON
  cache (``$REPRO_TORCH_AUTOTUNE_CACHE``, default
  ``~/.cache/repro_torch/autotune_cache.json``).
* :mod:`repro_torch.tuning.quality`— the measured precision-SNR gate
  (imported lazily: it pulls in the SAR pipeline).

Layering: ``repro_torch.tuning`` sits above ``repro_torch.kernels`` and
below ``repro_torch.core.plan``.
"""
from repro_torch.tuning.cache import (
    CACHE_SCHEMA,
    TuneCache,
    clear_memory_cache,
    default_cache_path,
    get_cache,
    migrate_legacy_doc,
    migrate_schema1_doc,
    validate_cache_doc,
)
from repro_torch.tuning.search import (
    DEFAULT_SNR_GATE_DB,
    TIMING_REPEATS_FLOOR,
    SearchResult,
    kernel_measure,
    best_config,
    cached_config,
    cached_schedule,
    measured_search,
    mega_measure,
    schedule_frontier,
    search_kernel,
    search_schedule,
)
from repro_torch.tuning.space import (
    CONFIG_KEYS,
    KIND_KERNEL,
    KIND_PIPELINE,
    MEGA_KEYS,
    SEGMENT_KEYS,
    SPECTRAL_KEYS,
    KernelConfig,
    Schedule,
    ScheduleProblem,
    SegmentConfig,
    SegmentShape,
    TuneKey,
    bucket_batch,
    candidates,
    default_backend,
    device_fingerprint,
    factorizations,
)
from repro_torch.tuning import cost

__all__ = [
    "CACHE_SCHEMA", "CONFIG_KEYS", "DEFAULT_SNR_GATE_DB", "KIND_KERNEL",
    "KIND_PIPELINE", "KernelConfig", "MEGA_KEYS", "SEGMENT_KEYS",
    "SPECTRAL_KEYS", "Schedule", "ScheduleProblem", "SearchResult",
    "SegmentConfig", "SegmentShape", "TIMING_REPEATS_FLOOR",
    "TuneCache", "TuneKey", "best_config", "bucket_batch", "cached_config",
    "cached_schedule", "candidates", "clear_memory_cache", "cost",
    "default_backend", "default_cache_path", "device_fingerprint",
    "factorizations",
    "get_cache", "kernel_measure", "measured_search", "mega_measure",
    "migrate_legacy_doc", "migrate_schema1_doc", "schedule_frontier",
    "search_kernel", "search_schedule", "validate_cache_doc",
]
