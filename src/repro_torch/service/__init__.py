"""Production-shaped SAR focusing service over the SpectralPlan executor
(the port of the JAX package's ``repro.service``).

An asyncio request front end that coalesces same-(SceneConfig, variant,
Precision) requests into (B, na, nr) micro-batches under a
deadline/max-batch policy, hands each batch off to a worker pool of
executor lanes (continuous batching: batch k+1 coalesces and pads while
batch k computes; over-budget scenes stream on a dedicated lane),
schedules flushes earliest-deadline first with pre-dispatch cancellation
of past-deadline work, executes through warm per-plan caches on the
`local` backend (the port's hand-written kernels on the CUDA card) or
the `sharded` one (the same kernels on per-device slabs of a device
mesh, corner turns between them), enforces a per-request precision
SNR gate, applies admission backpressure with deadline-aware shedding,
degrades along the reference's failure ladder, and emits
latency/goodput/lane-occupancy metrics in the BENCH_*.json format.

    from repro_torch.service import FocusService, ServiceConfig
    svc = FocusService(ServiceConfig(max_batch=4, max_delay_ms=5.0))
    await svc.start(warm=[(cfg, "fused3", None)])
    image = await svc.focus(raw, cfg, deadline_ms=250.0)

``FocusService`` and ``LocalBackend`` run on the card unless given
``device="cpu"``, and raise without one.
"""
from repro_torch.service.backends import (  # noqa: F401
    BACKENDS,
    LocalBackend,
    ShardedBackend,
    make_backend,
)
from repro_torch.service.batcher import MicroBatcher  # noqa: F401
from repro_torch.service.faults import (  # noqa: F401
    ChaosBackend,
    FaultInjector,
    FaultSpec,
    SimulatedFailure,
    scene_digest,
    seeded_schedule,
)
from repro_torch.service.metrics import ServiceMetrics  # noqa: F401
from repro_torch.service.queue import (  # noqa: F401
    BatchKey,
    FocusRequest,
    RequestCancelled,
    RequestQueue,
    ServiceOverloaded,
    SnrGateViolation,
)
from repro_torch.service.resilience import (  # noqa: F401
    BreakerBoard,
    CircuitBreaker,
    HealthSentinel,
    LaneStalled,
    OutputCorrupted,
    RetryPolicy,
)
from repro_torch.service.service import (  # noqa: F401
    FocusService,
    ServiceConfig,
)
from repro_torch.service.workers import (  # noqa: F401
    Lane,
    WorkerPool,
)
