"""Failure-domain primitives for the focusing service.

The serving stack degrades along TIERS, never cliffs: a failing
single-dispatch megakernel route falls back to its per-axis twin
(bit-identical, both through the hand-written kernels; a failing
per-axis dispatch raises, as nothing below it launches the kernels), a
tripped bs16 SNR gate falls back to the f32 verification tier, and a
poisoned coalesced batch bisects so one bad scene fails alone. Four small primitives carry
that policy:

``CircuitBreaker``   Per-route failure counter with cooldown/half-open
                     probing, so a persistently broken route stops being
                     retried on the hot path but is re-probed after the
                     cooldown (one request at a time) and closes again
                     the moment a probe succeeds.
``RetryPolicy``      Deadline-aware bounded retry: seeded jittered
                     exponential backoff whose sleep is NEVER scheduled
                     past the earliest live request deadline — a retry
                     that cannot finish in time is not attempted.
``HealthSentinel``   Output health check per scene (finite values +
                     input/output energy envelope) that converts silent
                     numerical corruption (NaN/Inf, zeroed or exploded
                     output) into a typed per-request error instead of a
                     wrong image handed to the caller.
``LaneStalled`` / ``OutputCorrupted``  The typed errors the degraded
                     paths raise, so callers (and the chaos harness) can
                     tell a supervised recovery from an unknown crash.

Everything here is pure policy — no asyncio, no device work — so it is
unit-testable with a fake clock and reusable outside the service.
"""
from __future__ import annotations

import math
import random
import threading
import time
from typing import Dict, Optional

import numpy as np


class LaneStalled(RuntimeError):
    """A lane's device thread exceeded its stall watchdog timeout; the
    lane was restarted and the batch is eligible for retry."""


class OutputCorrupted(RuntimeError):
    """The output health sentinel rejected a focused image (non-finite
    values or energy outside the physical envelope) and retries were
    exhausted — the caller gets this instead of a silently wrong image."""


class CircuitBreaker:
    """Three-state (closed / open / half_open) failure breaker.

    closed     the route serves normally; ``threshold`` consecutive
               failures open it.
    open       ``allow()`` is False until ``cooldown_s`` elapses, then
               the breaker moves to half_open and admits ONE probe.
    half_open  the probe's outcome decides: success closes, failure
               re-opens (and re-arms the cooldown). A probe that
               VANISHES without an outcome (the probe request was shed
               or deadline-dropped before its dispatch resolved) does
               not wedge the breaker: after another ``cooldown_s`` with
               no outcome recorded, ``allow()`` admits a fresh probe.

    ``clock`` is injectable for deterministic tests. Thread-safe: routes
    are consulted from lane threads and the event loop.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0
        self.trips = 0
        self._t_open = -math.inf
        self._t_probe = -math.inf

    def allow(self) -> bool:
        """May this route serve the next request? In half_open only the
        single call that observes the cooldown expiry gets True (the
        probe); concurrent callers keep seeing False until the probe
        resolves — or, if the probe vanished without recording an
        outcome, until another cooldown elapses and a fresh probe is
        admitted."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self._t_open >= self.cooldown_s:
                    self.state = "half_open"
                    self._t_probe = self._clock()
                    return True
                return False
            # half_open: probe in flight, unless it evaporated
            if self._clock() - self._t_probe >= self.cooldown_s:
                self._t_probe = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half_open" or self.failures >= self.threshold:
                if self.state != "open":
                    self.trips += 1
                self.state = "open"
                self._t_open = self._clock()


class BreakerBoard:
    """Named-breaker registry (one breaker per route x scene-shape x
    precision). Lazily creates breakers with shared defaults."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(self.threshold, self.cooldown_s,
                                    clock=self._clock)
                self._breakers[name] = br
            return br

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {name: {"state": br.state, "failures": br.failures,
                           "trips": br.trips}
                    for name, br in sorted(self._breakers.items())}


class RetryPolicy:
    """Bounded, seeded-jitter, deadline-aware retry budget.

    ``budget(attempt, t_deadline)`` returns the backoff sleep (seconds)
    for retry number ``attempt`` (0-based count of retries already
    spent), or None when the budget is exhausted — either ``max_retries``
    is reached or the sleep would land past ``t_deadline`` (monotonic
    seconds; the retry itself would be wasted work that cannot meet the
    deadline). Jitter is drawn from a seeded PRNG so replays are
    deterministic.
    """

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.025,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 seed: int = 0, clock=time.monotonic):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._clock = clock

    def backoff(self, attempt: int) -> float:
        base = self.backoff_s * self.multiplier ** max(0, attempt)
        return base * (1.0 + self.jitter * self._rng.random())

    def budget(self, attempt: int,
               t_deadline: float = math.inf) -> Optional[float]:
        if attempt >= self.max_retries:
            return None
        delay = self.backoff(attempt)
        if self._clock() + delay >= t_deadline:
            return None
        return delay


class HealthSentinel:
    """Per-scene output health check: finite values and an input/output
    energy envelope.

    The focusing chains conserve energy up to a shape-dependent constant
    (measured out/in ratios run ~1 for CSA and ~n/2 for the unnormalized
    RDA/omega-K ffts — well inside 1e6 either way), so the envelope is a
    coarse physical sanity band, not a tolerance: a healthy pipeline
    passes with orders of magnitude of margin while zeroed, exploded, or
    NaN/Inf output — the silent-corruption modes a dying accelerator
    produces — is flagged and converted into a typed per-request error.

    ``check`` returns None for a healthy image, else a human-readable
    reason string.
    """

    def __init__(self, envelope: float = 1e6):
        if envelope <= 1.0:
            raise ValueError("envelope must be > 1")
        self.envelope = envelope

    def check(self, raw: np.ndarray, image: np.ndarray) -> Optional[str]:
        img = np.asarray(image)
        if not np.all(np.isfinite(img.view(np.float32)
                                  if img.dtype == np.complex64 else img)):
            return "non-finite values in focused image"
        e_in = float(np.sum(np.abs(np.asarray(raw)) ** 2))
        if e_in == 0.0:
            return None                     # zero scene: nothing to compare
        e_out = float(np.sum(np.abs(img) ** 2))
        if e_out == 0.0:
            return "all-zero focused image for a non-zero scene"
        ratio = e_out / e_in
        if ratio > self.envelope or ratio < 1.0 / self.envelope:
            return (f"focused-image energy ratio {ratio:.3e} outside "
                    f"[{1.0 / self.envelope:.0e}, {self.envelope:.0e}] "
                    "envelope")
        return None
