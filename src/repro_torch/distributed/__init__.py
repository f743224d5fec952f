from repro_torch.distributed.fault import (  # noqa: F401
    FailureInjector,
    PreemptionHandler,
    SimulatedFailure,
    StragglerWatchdog,
    run_with_restarts,
)
