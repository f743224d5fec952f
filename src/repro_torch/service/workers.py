"""Worker pool: N executor lanes over a serving backend.

One executor thread awaited inline by the batcher would leave the device
idle while the next batch pads and uploads, and drain the queue in
lockstep with device completions (single-flight). The pool runs batches
on **lanes** instead:

* ``fused<i>`` lanes (``ServiceConfig.lanes`` of them) carry coalesced
  in-memory micro-batches. Admission routes each
  :class:`~repro_torch.service.queue.BatchKey` to the lane with the least
  predicted backlog, weighted by the roofline model's
  :func:`repro_torch.tuning.cost.serve_batch_seconds` — the same
  predicted-seconds arithmetic that ranks kernel schedules prices lane
  load, so a 1024² batch counts for more backlog than a 256² one.
* the ``stream`` lane carries over-budget scenes (the ``run_streamed``
  route) so a multi-second big scene never heads-of-line-blocks the
  coalesced small-scene traffic.

Each lane is one executor thread plus an asyncio semaphore of
``inflight_cap`` slots (default 2: one batch on device, one staged —
double-buffered host staging). The batcher's hand-off acquires a slot
and returns; when a lane's slots are full the hand-off parks, which is
the in-flight-cap backpressure that lets the queue backlog coalesce. On
a CUDA card the backend runs each lane thread's batches on a CUDA stream
of that lane's own, so one lane's copies overlap another's kernels.

Exclusive work: lanes run batches under the read side of a
reader-writer lock, and the SNR-gate measurement and warms take the
write side — many concurrent batches, never a batch beside exclusive
work. The port has no process-global numerics flag to protect (the JAX
package's gate toggles x64 for its whole process); the lock keeps the
gate's two focusing runs and a warm's timed sweep off a card that lanes
are feeding, so neither measures contended time, and it keeps the
lock's contract (a stalled lane's hold is force-released, exclusive
work never waits on a dead thread) that the resilience tests hold.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import threading
import time
from typing import Dict, List, Optional

from repro_torch.distributed.fault import StragglerWatchdog
from repro_torch.service.queue import BatchKey
from repro_torch.service.resilience import LaneStalled
from repro_torch import tuning


class _ReadToken:
    """One read-side hold on the RW lock. ``release()`` is idempotent
    and callable from ANY thread: when a stall watchdog restarts a lane,
    the abandoned device thread may still hold the read side — the
    restart force-releases its token so a pending gate writer is never
    deadlocked, and the abandoned thread's own eventual release is a
    no-op."""

    __slots__ = ("_lock", "_released")

    def __init__(self, lock: "_RWLock"):
        self._lock = lock
        self._released = False

    def release(self) -> None:
        with self._lock._cond:
            if self._released:
                return
            self._released = True
            self._lock._readers -= 1
            if self._lock._readers == 0:
                self._lock._cond.notify_all()


class _RWLock:
    """Minimal reader-writer lock: many readers (lane batches) or one
    writer (gate measurement / warm), writer-preferring so a pending
    exclusive task is not starved by a stream of batches."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> _ReadToken:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
            return _ReadToken(self)

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class _Dispatch:
    """Supervision record for one hand-off to a lane thread. ``t_start``
    is written by the lane thread the moment the callable actually
    begins (time queued behind a sibling on the lane's single worker
    thread never counts toward the stall clock) and read by the
    event-loop supervisor; ``token`` is this dispatch's gate-lock read
    hold, so a stall force-releases exactly the stalled dispatch's
    token and never a healthy sibling's."""

    __slots__ = ("t_start", "token")

    def __init__(self):
        self.t_start: Optional[float] = None
        self.token: Optional[_ReadToken] = None


class Lane:
    """One executor lane: a device-work thread, an in-flight slot
    semaphore, and occupancy/backlog accounting."""

    def __init__(self, name: str, kind: str, inflight_cap: int):
        if inflight_cap < 1:
            raise ValueError("inflight_cap must be >= 1")
        self.name = name
        self.kind = kind                  # "batch" | "stream"
        self.inflight_cap = inflight_cap
        self.inflight = 0
        self.backlog_s = 0.0              # predicted seconds in flight
        self.busy_s = 0.0                 # measured device-thread seconds
        self.batches = 0
        # -- supervision state: an EWMA of completed-batch seconds (the
        # stall watchdog's baseline), a monotonic max (robust to lanes
        # serving mixed scene sizes), the distributed straggler watchdog
        # flagging slow-but-alive dispatches, and a restart generation.
        self.ewma_s: Optional[float] = None
        self.max_s = 0.0
        self.generation = 0
        self.stalls = 0
        self.watchdog = StragglerWatchdog()
        self._sem: Optional[asyncio.Semaphore] = None
        self._executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None

    def start(self) -> None:
        """(Re)create the loop-bound semaphore and the executor thread —
        called from the running event loop by WorkerPool.start()."""
        self._sem = asyncio.Semaphore(self.inflight_cap)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"lane-{self.name}")

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._sem = None

    # -- supervision ---------------------------------------------------------
    def note_done(self, seconds: float) -> None:
        """Fold one COMPLETED batch's device-RUN seconds into the stall
        baseline (failures and stalls are excluded — they would bias the
        watchdog toward false positives after fast failures; queue wait
        behind a lane sibling is measured out on the lane thread, so it
        neither inflates the baseline nor double-counts busy time)."""
        self.ewma_s = (seconds if self.ewma_s is None
                       else 0.3 * seconds + 0.7 * self.ewma_s)
        self.max_s = max(self.max_s, seconds)
        self.watchdog.record(self.batches, seconds)

    def stall_timeout(self, factor: float, floor_s: float) -> float:
        """Seconds a dispatch may run before the lane is declared dead.
        Based on the slowest completed batch (not the EWMA alone) so a
        lane serving mixed scene sizes never false-trips on its largest
        key; the floor covers the cold lane before any completion."""
        base = max(self.max_s, self.ewma_s or 0.0)
        return max(floor_s, factor * base)

    def restart(self, stalled: Optional[_Dispatch] = None) -> None:
        """Replace the executor thread after a stall. The semaphore is
        KEPT: hand-offs already parked on `acquire` simply dispatch onto
        the fresh executor — that is the not-yet-dispatched-work requeue.
        Hand-offs already QUEUED on the dead executor are cancelled by
        the teardown; WorkerPool.run_batch translates that cancellation
        into a retryable LaneStalled so they re-run through the normal
        recovery ladder instead of leaving request futures pending.
        Only the STALLED dispatch's gate-lock read token is
        force-released (idempotently) — a healthy dispatch still running
        keeps its hold, so a gate writer can never toggle global config
        under live device work — which is enough to unblock a pending
        writer because the abandoned thread will never release it."""
        old = self._executor
        if old is not None:
            old.shutdown(wait=False, cancel_futures=True)
        if stalled is not None and stalled.token is not None:
            stalled.token.release()
        self.generation += 1
        self.stalls += 1
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"lane-{self.name}")

    async def acquire(self, predicted_s: float = 0.0) -> None:
        """Take one in-flight slot (parks when the lane is at its cap —
        the batcher's backpressure point)."""
        await self._sem.acquire()
        self.inflight += 1
        self.backlog_s += predicted_s

    def release(self, predicted_s: float = 0.0,
                busy_s: float = 0.0) -> None:
        self.inflight -= 1
        self.backlog_s = max(0.0, self.backlog_s - predicted_s)
        self.busy_s += busy_s
        self.batches += 1
        self._sem.release()


class WorkerPool:
    """Lane container + router. Owns every device-work thread of the
    service (batches, streams, gate measurements, warms)."""

    def __init__(self, lanes: int = 2, inflight_cap: int = 2):
        if lanes < 1:
            raise ValueError("worker pool needs at least one lane")
        self.gate_lock = _RWLock()
        self.batch_lanes: List[Lane] = [
            Lane(f"fused{i}", "batch", inflight_cap)
            for i in range(lanes)]
        self.stream_lane = Lane("stream", "stream", inflight_cap)
        self.lanes: List[Lane] = [*self.batch_lanes, self.stream_lane]
        self._started = False
        self.t_start = time.monotonic()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Create executors + loop-bound semaphores. Must run inside the
        event loop the lanes will serve (semaphores bind to it)."""
        for lane in self.lanes:
            lane.start()
        self.t_start = time.monotonic()
        self._started = True

    def shutdown(self) -> None:
        for lane in self.lanes:
            lane.shutdown()
        self._started = False

    @property
    def started(self) -> bool:
        return self._started

    # -- routing ------------------------------------------------------------
    def predicted_seconds(self, key: BatchKey, batch: int = 1) -> float:
        """The roofline's price of one batch under this key — the lane
        routing weight (tuning.cost.serve_batch_seconds)."""
        return tuning.cost.serve_batch_seconds(
            key.scene.na, key.scene.nr, batch=batch,
            precision=key.precision, streamed=key.stream)

    def route(self, key: BatchKey) -> Lane:
        """Streamed (over-budget) keys go to the dedicated stream lane;
        coalesced batches go to the least-backlogged fused lane by
        predicted seconds (ties resolve to the lowest lane index, so
        routing is deterministic)."""
        if key.stream:
            return self.stream_lane
        return min(self.batch_lanes,
                   key=lambda lane: (lane.backlog_s, lane.name))

    # -- execution ----------------------------------------------------------
    async def run_batch(self, lane: Lane, fn, *args,
                        stall_timeout: Optional[float] = None):
        """Await ``fn(*args)`` on the lane thread (shared lock held);
        returns (result, seconds the callable RAN on the lane thread —
        time queued behind a lane sibling is excluded from both the
        supervision baseline and busy accounting).

        ``stall_timeout`` arms the lane supervisor: a dispatch that
        neither returns nor raises within the timeout of RUNNING time
        (the clock starts when the callable begins on the lane thread,
        not at submit — a batch queued behind its sibling on the lane's
        single worker thread accrues no stall credit) is declared a dead
        lane — the lane's executor is replaced (work already parked on
        its in-flight semaphore re-dispatches onto the fresh thread) and
        :class:`~repro_torch.service.resilience.LaneStalled` is raised so the
        caller's retry policy can re-run the batch.

        A hand-off still QUEUED on an executor torn down by a sibling's
        restart is cancelled by that teardown; the cancellation is
        translated into LaneStalled here — CancelledError is a
        BaseException the service's `except Exception` recovery ladder
        would never see, and an untranslated escape would leave the
        batch's request futures pending forever."""
        disp = _Dispatch()
        cfut = lane._executor.submit(self._shared_call, lane, disp,
                                     fn, *args)
        fut = asyncio.wrap_future(cfut)
        try:
            if stall_timeout is None:
                result, secs = await fut
            else:
                result, secs = await self._supervise(
                    lane, disp, fut, stall_timeout)
        except asyncio.CancelledError:
            if not cfut.cancelled():
                raise                      # genuine task cancellation
            raise LaneStalled(
                f"lane {lane.name}: queued hand-off cancelled by a lane "
                f"restart (generation {lane.generation}); eligible for "
                "re-dispatch on the fresh executor") from None
        lane.note_done(secs)
        return result, secs

    async def _supervise(self, lane: Lane, disp: _Dispatch,
                         fut: "asyncio.Future", stall_timeout: float):
        """Await ``fut`` under the stall watchdog, counting only RUNNING
        time: while ``disp.t_start`` is None the hand-off is still
        queued behind a sibling (whose own watchdog covers a hang there)
        and each wait simply re-arms."""
        while True:
            started = disp.t_start
            if started is None:
                timeout = stall_timeout
            else:
                timeout = stall_timeout - (time.perf_counter() - started)
                if timeout <= 0.0:
                    self.restart_lane(lane, disp)
                    raise LaneStalled(
                        f"lane {lane.name}: dispatch exceeded the "
                        f"{stall_timeout:.2f}s stall watchdog; lane "
                        f"restarted (generation {lane.generation})"
                    ) from None
            try:
                return await asyncio.wait_for(asyncio.shield(fut), timeout)
            except asyncio.TimeoutError:
                continue

    def restart_lane(self, lane: Lane,
                     stalled: Optional[_Dispatch] = None) -> None:
        """Supervisor action: replace a dead lane's executor thread.
        Parked hand-offs keep their semaphore slots and re-dispatch onto
        the fresh thread; the stalled dispatch's shared-lock hold is
        force-released (see Lane.restart)."""
        lane.restart(stalled)

    def _shared_call(self, lane: Lane, disp: _Dispatch, fn, *args):
        token = self.gate_lock.acquire_read()
        disp.token = token          # before t_start: the supervisor only
        disp.t_start = time.perf_counter()   # acts once t_start is set
        try:
            return fn(*args), time.perf_counter() - disp.t_start
        finally:
            token.release()

    async def run_exclusive(self, fn, *args):
        """Await ``fn(*args)`` on lane 0's thread under the EXCLUSIVE
        side of the gate lock — for work that must not share the card with
        lane batches (the SNR-gate measurement, a warm's timed sweep) or
        mutates warm caches."""
        return await asyncio.wrap_future(
            self.batch_lanes[0]._executor.submit(
                self._exclusive_call, fn, *args))

    def _exclusive_call(self, fn, *args):
        self.gate_lock.acquire_write()
        try:
            return fn(*args)
        finally:
            self.gate_lock.release_write()

    # -- observability ------------------------------------------------------
    def occupancy(self) -> Dict[str, float]:
        """Per-lane busy fraction since start() — the metrics export."""
        elapsed = max(time.monotonic() - self.t_start, 1e-9)
        return {lane.name: min(1.0, lane.busy_s / elapsed)
                for lane in self.lanes}

    def snapshot(self) -> Dict[str, dict]:
        return {lane.name: {
            "kind": lane.kind,
            "inflight": lane.inflight,
            "inflight_cap": lane.inflight_cap,
            "backlog_s": lane.backlog_s,
            "busy_s": lane.busy_s,
            "batches": lane.batches,
            "stalls": lane.stalls,
            "generation": lane.generation,
        } for lane in self.lanes}
