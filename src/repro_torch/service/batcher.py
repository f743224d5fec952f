"""Deadline-aware continuous micro-batcher.

Coalesces same-:class:`~repro_torch.service.queue.BatchKey` requests into
``(B, na, nr)`` micro-batches: a key's first pending request starts a
flush deadline (``max_delay_ms``); the bucket flushes when it reaches
``max_batch`` or the deadline fires, whichever is first. Requests routed
through the streaming executor never coalesce (one host-resident scene is
already over the device budget; B of them certainly are).

**Continuous batching.** ``execute`` is a HAND-OFF, not a wait: the
service's dispatch callback acquires a worker-pool lane slot, schedules
the device work as a background task, and returns — so the batcher
resumes draining immediately and batch k+1 coalesces, sweeps, and pads
while batch k runs on device. Backpressure re-appears exactly where it
belongs: when every slot of the routed lane is in flight, the hand-off
awaits a slot (the per-lane in-flight cap), the batcher parks mid-flush,
and the queue backlog coalesces into full batches behind it.

**Deadline scheduling.** Buckets whose flush deadline has fired are
flushed in earliest-request-deadline order (EDF; priority breaks ties).
At flush time, before any padding, each bucket is swept: requests whose
client cancelled the returned future are silently dropped, and requests
already past their ``deadline_ms`` are dropped with
:class:`~repro_torch.service.queue.RequestCancelled` — a request that can no
longer meet its deadline must not cost a dispatch. On shutdown (STOP),
remaining buckets flush in the same EDF order — including when STOP is
dequeued mid-drain with non-stale buckets still pending.

Under overload the service sheds the LATEST-deadline pending request
(:meth:`MicroBatcher.shed_latest`) instead of rejecting an
earlier-deadline arrival at admission.
"""
from __future__ import annotations

import math
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from repro_torch.service.queue import (
    STOP,
    BatchKey,
    FocusRequest,
    RequestCancelled,
    RequestQueue,
    now,
)

ExecuteFn = Callable[[BatchKey, List[FocusRequest]], Awaitable[None]]
DropFn = Callable[[FocusRequest, str], None]


class MicroBatcher:
    """Pulls from the queue, buckets by key, flushes on size or deadline
    (EDF across buckets), hands flushes off without waiting for device
    completion."""

    def __init__(self, queue: RequestQueue, execute: ExecuteFn,
                 max_batch: int = 4, max_delay_ms: float = 5.0,
                 on_drop: Optional[DropFn] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.queue = queue
        self.execute = execute
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.on_drop = on_drop
        self._pending: Dict[BatchKey, List[FocusRequest]] = {}
        self._flush_deadline: Dict[BatchKey, float] = {}
        # requests popped from their bucket but still awaiting a lane
        # slot inside execute(): they are backlog (admission counts them)
        # but no longer sheddable/coalescible
        self._dispatching = 0

    def pending_count(self) -> int:
        """Not-yet-dispatched backlog: bucketed + awaiting a lane slot."""
        return (sum(len(v) for v in self._pending.values())
                + self._dispatching)

    # -- overload shedding --------------------------------------------------
    def shed_latest(self, before: float,
                    priority: int = 0) -> Optional[FocusRequest]:
        """Remove and return the pending request whose deadline is the
        LATEST — provided it is strictly later than ``before`` (the
        incoming request's deadline) or, at equal deadlines, of strictly
        lower ``priority``. Returns None when nothing pending is a worse
        candidate than the arrival, i.e. shedding would not help."""
        worst: Optional[Tuple[float, int, BatchKey, int]] = None
        for key, reqs in self._pending.items():
            for i, r in enumerate(reqs):
                cand = (r.t_deadline, -r.priority, key, i)
                if worst is None or cand[:2] > worst[:2]:
                    worst = cand
        if worst is None:
            return None
        t_dead, neg_prio, key, i = worst
        if not (t_dead > before
                or (t_dead == before and -neg_prio < priority)):
            return None
        victim = self._pending[key].pop(i)
        if not self._pending[key]:
            del self._pending[key]
            self._flush_deadline.pop(key, None)
        return victim

    # -- scheduling ---------------------------------------------------------
    def _bucket_rank(self, key: BatchKey) -> Tuple[float, int, float]:
        """EDF sort key for a bucket: earliest request deadline first,
        then highest priority, then earliest flush deadline."""
        reqs = self._pending.get(key, ())
        t_dead = min((r.t_deadline for r in reqs), default=math.inf)
        prio = max((r.priority for r in reqs), default=0)
        return (t_dead, -prio, self._flush_deadline.get(key, math.inf))

    def _edf_order(self, keys) -> List[BatchKey]:
        return sorted(keys, key=self._bucket_rank)

    async def run(self) -> None:
        """The batcher task. Exits after draining when STOP is dequeued."""
        stop = False
        while not stop:
            timeout = None
            if self._flush_deadline:
                timeout = max(0.0,
                              min(self._flush_deadline.values()) - now())
            req = await self.queue.get(timeout)
            # Drain the whole backlog into buckets BEFORE any deadline
            # check: requests that queued up behind an executing batch
            # would otherwise degenerate into B=1 flushes; draining first
            # lets the backlog coalesce to max_batch. The flush deadline
            # only governs requests still waiting for company once the
            # queue is empty.
            while req is not None:
                if req is STOP:
                    stop = True
                    break
                bucket = self._pending.setdefault(req.key, [])
                if not bucket:
                    self._flush_deadline[req.key] = (req.t_submit
                                                     + self.max_delay_s)
                bucket.append(req)
                if len(bucket) >= self.max_batch or req.stream:
                    await self._flush(req.key)
                req = await self.queue.get(0)
            # The deadline sweep runs on EVERY loop iteration — including
            # the one that dequeued STOP mid-drain: buckets whose flush
            # deadline fired while the backlog drained must still go out
            # in EDF order, not fall through to the shutdown flush.
            t = now()
            expired = [k for k, d in self._flush_deadline.items()
                       if d <= t]
            for key in self._edf_order(expired):
                await self._flush(key)
        for key in self._edf_order(list(self._pending)):
            await self._flush(key)

    async def _flush(self, key: BatchKey) -> None:
        reqs = self._pending.pop(key, [])
        self._flush_deadline.pop(key, None)
        live = self._sweep(reqs)
        if not live:
            return
        # hand-off: execute() returns once the batch holds a lane slot
        # and its device task is scheduled — NOT when the device is done.
        # The popped requests count as backlog until the hand-off lands.
        self._dispatching += len(live)
        try:
            await self.execute(key, live)
        finally:
            self._dispatching -= len(live)

    def _sweep(self, reqs: List[FocusRequest]) -> List[FocusRequest]:
        """Drop client-cancelled and past-deadline requests BEFORE the
        batch pads: neither may cost device work. Past-deadline futures
        resolve with RequestCancelled; cancelled futures are already
        resolved by the client."""
        t = now()
        live = []
        for r in reqs:
            if r.future.cancelled():
                if self.on_drop:
                    self.on_drop(r, "client_cancelled")
                continue
            if r.t_deadline <= t:
                if not r.future.done():
                    r.future.set_exception(RequestCancelled(
                        f"deadline_ms={r.deadline_ms:g} exceeded "
                        f"{(t - r.t_deadline) * 1e3:.1f} ms before "
                        "dispatch; dropped without device work"))
                if self.on_drop:
                    self.on_drop(r, "deadline")
                continue
            live.append(r)
        return live
