"""Bounded async request queue — the service's backpressure boundary.

Every request enters through :meth:`RequestQueue.put`, which REJECTS
(raises :class:`ServiceOverloaded`) instead of blocking once the bound is
reached: under sustained overload an unbounded queue only converts
throughput saturation into unbounded latency, so the service sheds load
at admission and the caller decides whether to retry. The exception
carries the observed backlog, the bound, and a ``retry_after_hint``
(seconds, derived from an EWMA of recent per-request service time) so
callers can back off intelligently instead of hammering the bound.
Accepted requests carry an :class:`asyncio.Future` the scheduler resolves
with the focused image (or an exception).

Requests may also carry a ``deadline_ms``: the scheduler flushes buckets
in earliest-deadline order, drops requests already past their deadline
before padding them into a batch (their futures raise
:class:`RequestCancelled`), and under overload sheds the LATEST-deadline
pending work first rather than rejecting an earlier-deadline arrival
blindly.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.sar.geometry import SceneConfig

# seed for the service-time EWMA before the first batch completes: the
# hint only has to be a sane order of magnitude, not a prediction
_SERVICE_TIME_SEED_S = 0.05
_EWMA_ALPHA = 0.2
# floor for retry_after_hint: the EWMA can be driven arbitrarily small
# by a run of fast (or clock-degenerate) batches, and a non-positive
# hint tells callers to retry immediately — exactly the hammering the
# hint exists to prevent
_RETRY_HINT_FLOOR_S = 1e-3


class ServiceOverloaded(RuntimeError):
    """Admission rejected: the request backlog is at its configured bound.

    Machine-readable attributes (also rendered into the message):

    ``depth``             backlog observed at rejection (queued requests
                          plus the scheduler's not-yet-dispatched buckets)
    ``bound``             the configured admission bound
    ``retry_after_hint``  seconds a caller should wait before retrying —
                          the backlog times an EWMA of recent per-request
                          service time, i.e. roughly when the current
                          backlog will have drained
    """

    def __init__(self, depth: int, bound: int, retry_after_hint: float):
        self.depth = int(depth)
        self.bound = int(bound)
        self.retry_after_hint = float(retry_after_hint)
        super().__init__(
            f"backlog at bound (depth {self.depth} >= bound {self.bound}); "
            f"request rejected; retry_after_hint={self.retry_after_hint:.3f}s")


class RequestCancelled(RuntimeError):
    """The request was dropped before execution: past its deadline at
    flush time, or shed under overload to admit earlier-deadline work."""


class SnrGateViolation(ValueError):
    """The requested precision's measured SNR deviation exceeds the
    service's quality gate (ServiceConfig.snr_gate_db)."""


class BatchKey(NamedTuple):
    """Requests coalesce into one micro-batch iff their keys are equal:
    same scene geometry (filters, FFT lengths), same plan variant, same
    precision policy, and the same streamed-vs-in-memory route.
    Deadlines and priorities are per-request scheduling state, NOT part
    of the key — a tight-deadline request still coalesces with a lax one."""

    scene: SceneConfig
    variant: str
    precision: Optional[str]
    stream: bool


@dataclasses.dataclass
class FocusRequest:
    """One in-flight focusing request (host scene -> focused image)."""

    raw: np.ndarray                 # (na, nr) complex64 host scene
    scene: SceneConfig
    variant: str
    precision: Optional[str]
    future: asyncio.Future          # resolves to the (na, nr) image
    t_submit: float                 # monotonic seconds at admission
    stream: bool = False            # over device budget: run_streamed route
    deadline_ms: Optional[float] = None  # completion deadline, relative to
                                         # submission; None = no deadline
    priority: int = 0               # EDF/shed tiebreak: higher wins

    @property
    def key(self) -> BatchKey:
        return BatchKey(self.scene, self.variant, self.precision,
                        self.stream)

    @property
    def t_deadline(self) -> float:
        """Absolute monotonic deadline (+inf when none was requested)."""
        if self.deadline_ms is None:
            return math.inf
        return self.t_submit + self.deadline_ms / 1e3


class _Stop:
    pass


STOP = _Stop()


class RequestQueue:
    """asyncio FIFO with an explicit admission bound.

    The bound covers the whole pre-dispatch backlog, not just this FIFO:
    the scheduler drains the FIFO into coalescing buckets aggressively,
    so callers pass their bucketed count via ``extra`` and the bound is
    enforced against ``qsize + extra``."""

    def __init__(self, bound: int):
        if bound < 1:
            raise ValueError("queue bound must be >= 1")
        self.bound = bound
        self._q: asyncio.Queue = asyncio.Queue()
        self._service_time_s = _SERVICE_TIME_SEED_S

    def depth(self) -> int:
        return self._q.qsize()

    def note_service_time(self, seconds_per_request: float) -> None:
        """Fold one completed request's service time into the EWMA that
        prices ``retry_after_hint`` (called by the service per batch)."""
        if seconds_per_request > 0:
            self._service_time_s = (
                _EWMA_ALPHA * seconds_per_request
                + (1.0 - _EWMA_ALPHA) * self._service_time_s)

    def retry_after_hint(self, depth: int) -> float:
        """Seconds until a backlog of ``depth`` requests should have
        drained at the recently observed service rate. Clamped to a
        positive floor: a cold or degenerate EWMA must never tell
        callers to retry after 0 (or negative) seconds."""
        return max(_RETRY_HINT_FLOOR_S,
                   (depth + 1) * self._service_time_s)

    def put(self, req: FocusRequest, extra: int = 0) -> None:
        """Admit a request or raise :class:`ServiceOverloaded`.

        ``extra`` is backlog held outside this FIFO (the scheduler's
        pending buckets); the bound applies to the total."""
        depth = self._q.qsize() + max(0, extra)
        if depth >= self.bound:
            raise ServiceOverloaded(
                depth=depth, bound=self.bound,
                retry_after_hint=self.retry_after_hint(depth))
        self._q.put_nowait(req)

    def put_stop(self) -> None:
        """Enqueue the shutdown sentinel (bypasses the bound)."""
        self._q.put_nowait(STOP)

    def drain_nowait(self) -> list:
        """Remove and return everything currently queued (shutdown path:
        requests that raced admission behind the STOP sentinel must be
        failed, not leaked as forever-pending futures)."""
        out = []
        while True:
            try:
                item = self._q.get_nowait()
            except asyncio.QueueEmpty:
                return out
            if item is not STOP:
                out.append(item)

    async def get(self, timeout: Optional[float] = None):
        """Next request, STOP, or None when `timeout` elapses first."""
        if timeout is None:
            return await self._q.get()
        if timeout <= 0:
            try:
                return self._q.get_nowait()
            except asyncio.QueueEmpty:
                return None
        try:
            return await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return None


def now() -> float:
    return time.monotonic()
