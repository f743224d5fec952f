"""Fault tolerance: failure injection, straggler watchdog, restart policy
(the port's copy of the JAX package's ``repro.distributed.fault``, pure
Python).

On a fleet these hook the runtime's preemption notice and the
coordinator's health checks; the focusing service uses the injected-error
type and the straggler watchdog in-process (``repro_torch.service``), and
the restart logic (checkpoint -> reshard -> seek data stream -> resume) is
the same code that runs on a cluster.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / preemption in tests."""


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure when `step` hits any value in `at_steps`
    (each fires once)."""
    at_steps: tuple = ()

    def __post_init__(self):
        self._pending = set(self.at_steps)

    def check(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerWatchdog:
    """Tracks step wall times; flags steps slower than `factor` x the rolling
    median. On a fleet the launcher excludes the slow host and restarts from
    the last checkpoint (elastic re-mesh); here we record and report."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list = []
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        recent = sorted(self.times[-self.window:])
        median = recent[len(recent) // 2]
        slow = len(self.times) > 4 and seconds > self.factor * median
        if slow:
            self.flagged.append((step, seconds, median))
        return slow


class PreemptionHandler:
    """SIGTERM -> request a final checkpoint before exit (cloud preemption
    notice). Poll `should_stop` inside the train loop."""

    def __init__(self, install: bool = True):
        self._stop = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:
                pass  # not the main thread (tests)

    def _on_signal(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def trigger(self):  # for tests
        self._stop = True


def run_with_restarts(train_fn: Callable, restore_fn: Callable,
                      max_restarts: int = 3):
    """Generic restart-from-checkpoint policy.

    train_fn(state) -> state, raises SimulatedFailure on fault.
    restore_fn() -> state (latest checkpoint + data seek).
    """
    state = restore_fn()
    restarts = 0
    while True:
        try:
            return train_fn(state), restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            state = restore_fn()
