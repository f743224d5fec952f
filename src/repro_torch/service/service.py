"""FocusService — the async continuous-batching SAR focusing front end.

The port of the JAX package's ``repro.service.service`` on the port's
kernels: the same policy, on the CUDA card unless the caller passes
``device="cpu"``. Request lifecycle (docs/serving.md walks through the
reference's, which this one keeps):

1. **Admission** — ``focus()`` checks the per-request SNR gate (a
   precision whose measured deviation exceeds ``snr_gate_db`` is rejected
   before it costs a dispatch), sizes the scene against the device-memory
   budget (oversized scenes take the streaming route), and enqueues into
   the bounded request queue. At the bound, the service first tries to
   SHED the latest-deadline pending request (its future raises
   :class:`RequestCancelled`) to admit earlier-deadline work; only when
   nothing pending is a worse candidate does the caller see
   :class:`ServiceOverloaded` (which carries depth/bound/retry hint).
2. **Coalescing** — the batcher buckets requests by
   ``(SceneConfig, variant, precision)`` and flushes at ``max_batch`` or
   after ``max_delay_ms``; flush-ready buckets go out in earliest-
   deadline order, and client-cancelled or past-deadline requests are
   dropped before the batch pads.
3. **Dispatch** — the flush is a HAND-OFF: the batch acquires a slot on
   a worker-pool lane (``fused<i>`` lanes for coalesced batches, the
   ``stream`` lane for over-budget scenes; routing weighs lanes by the
   roofline's predicted seconds) and runs as a background task, so the
   batcher resumes draining immediately — batch k+1 coalesces and pads
   on the event loop while batch k computes on a lane thread
   (continuous batching; the per-lane in-flight cap is the backpressure).
4. **Completion** — per-request futures resolve with each request's
   ``(na, nr)`` image; batching is a kernel-grid extension, so the
   coalesced image is bit-identical to an unbatched ``Pipeline.run``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import math
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.sar.geometry import SceneConfig
from repro_torch.service import backends as backends_mod
from repro_torch.service.batcher import MicroBatcher
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.queue import (
    BatchKey,
    FocusRequest,
    RequestCancelled,
    RequestQueue,
    ServiceOverloaded,
    SnrGateViolation,
    now,
)
from repro_torch.service.resilience import (
    BreakerBoard,
    HealthSentinel,
    LaneStalled,
    OutputCorrupted,
    RetryPolicy,
)
from repro_torch.service.workers import Lane, WorkerPool

# poison-batch bisection recursion bound: max_batch is small (single
# digits), so 4 halvings always reach singletons
_MAX_BISECT_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-level policy knobs (per-request knobs ride on the request).

    variant: default plan variant for requests that don't name one.
    precision: default precision tier for requests that don't name one.
      The shipping default is 'bs16' (block-scaled f16 — per-line
      exponents carried through the kernels, throughput tier); it is
      still subject to the SNR gate like any explicit request. Set None
      (or 'f32') for the full-precision verification path, which never
      consults the gate.
    backend: 'local' | 'sharded' (see repro_torch.service.backends).
    max_batch: coalescing bound B — requests per micro-batch.
    max_delay_ms: deadline a lone request waits for batch company.
    max_queue: admission bound on the pre-dispatch backlog (queued +
      bucketed requests); beyond it submits shed latest-deadline pending
      work or raise ServiceOverloaded.
    lanes: worker-pool fused-batch lanes (plus one dedicated stream
      lane). Each lane is one executor thread; >1 overlaps host staging
      and device compute across batches.
    inflight_cap: in-flight batches per lane (2 = one on device + one
      staged, double-buffered host staging). The batcher parks when the
      routed lane is at its cap.
    shed: at the admission bound, drop the latest-deadline pending
      request (RequestCancelled) to admit an earlier-deadline arrival;
      False restores reject-at-bound.
    snr_gate_db: per-request precision quality gate — a request asking
      for a precision whose measured point-target SNR deviation exceeds
      this raises SnrGateViolation at admission ("Range, Not Precision":
      the gate, not throughput, decides admissibility).
    device_budget_bytes: scenes larger than this take the streaming route
      (Pipeline.run_streamed strips on 'local').
      None disables the check.
    stream_strips: strip count for the streaming route.
    schedule: sharded backend schedule ('corner2' generic plan lowering,
      'halo' single-turn RDA).
    """

    variant: str = "fused3"
    precision: Optional[str] = "bs16"
    backend: str = "local"
    max_batch: int = 4
    max_delay_ms: float = 5.0
    max_queue: int = 64
    lanes: int = 2
    inflight_cap: int = 2
    shed: bool = True
    snr_gate_db: float = 0.1
    device_budget_bytes: Optional[int] = None
    stream_strips: int = 4
    schedule: str = "corner2"
    # -- failure-domain knobs (docs/serving.md "Failure handling") -----------
    # max_retries: failed batch dispatches re-run up to this many times
    #   with jittered exponential backoff, never scheduled past the
    #   earliest live deadline in the batch.
    # retry_backoff_ms / retry_seed: the backoff base and the jitter
    #   PRNG seed (seeded -> chaos replays are deterministic).
    # bisect: a batch that exhausts its retries and holds >1 request is
    #   split in half and each half served independently, so one poison
    #   scene fails alone instead of killing its coalesced neighbors.
    # sentinel / sentinel_envelope: per-scene output health check
    #   (finite values + in/out energy envelope) converting silent
    #   numerical corruption into a retry, then OutputCorrupted.
    # stall_factor / stall_floor_s: lane supervision — a dispatch
    #   exceeding max(floor, factor x slowest completed batch) declares
    #   the lane dead; the lane restarts and the batch retries. None
    #   factor disables the watchdog.
    # tier_fallback: a DEFAULT-tier precision whose SNR gate trips (or
    #   whose output keeps failing the sentinel) falls back to the f32
    #   verification tier instead of erroring; explicit per-request
    #   precisions still raise SnrGateViolation — the caller asked for
    #   that tier by name.
    max_retries: int = 1
    retry_backoff_ms: float = 25.0
    retry_seed: int = 0
    bisect: bool = True
    sentinel: bool = True
    sentinel_envelope: float = 1e6
    stall_factor: Optional[float] = 6.0
    stall_floor_s: float = 30.0
    tier_fallback: bool = True
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0


def _default_precision_deviation(precision: str, device) -> float:
    """Measured SNR deviation (dB) for a precision policy on ``device``
    (the service's), from the in-library quality harness
    (repro_torch.tuning.quality — the same gate the kernel tuner applies).
    Fails CLOSED: if the harness is not importable the deviation is +inf
    and every non-f32 request is rejected — a service must never silently
    skip its quality gate."""
    try:
        from repro_torch.tuning.quality import precision_snr_deviation
    except Exception:
        return math.inf
    return precision_snr_deviation(precision, device=str(device))


class FocusService:
    """Async front end over the SpectralPlan executor. Construct, then
    ``await start()`` (optionally with warm keys); submit via ``focus``;
    ``await stop()`` drains and joins the batcher and every in-flight
    lane task.

    ``device=None`` is the CUDA card (raises without one), ``"cpu"`` the
    kernels' plain versions; it is where the default backend runs and
    where the default SNR gate focuses. With ``config.backend ==
    "sharded"`` the default backend runs on ``mesh``, or where it is None
    on every visible card (``device=None``) or on ``device`` alone."""

    def __init__(self, config: ServiceConfig = ServiceConfig(),
                 backend=None, precision_deviation=None, device=None,
                 mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.metrics = ServiceMetrics(self.device)
        self.queue = RequestQueue(config.max_queue)
        if backend is None:
            backend = (backends_mod.ShardedBackend(
                mesh=mesh, schedule=config.schedule, device=device)
                       if config.backend == "sharded"
                       else backends_mod.LocalBackend(device=self.device,
                                                      mesh=mesh))
        self.backend = backend
        self.batcher = MicroBatcher(self.queue, self._dispatch,
                                    max_batch=config.max_batch,
                                    max_delay_ms=config.max_delay_ms,
                                    on_drop=self._on_drop)
        self._precision_deviation = (
            precision_deviation or functools.partial(
                _default_precision_deviation, device=self.device))
        self._gate_cache: Dict[str, float] = {}
        # -- failure-domain policy (see resilience.py) -----------------------
        self._retry = RetryPolicy(max_retries=config.max_retries,
                                  backoff_s=config.retry_backoff_ms / 1e3,
                                  seed=config.retry_seed)
        self._sentinel = (HealthSentinel(config.sentinel_envelope)
                          if config.sentinel else None)
        # tier breakers: "tier:<precision>" opens after repeated gate
        # trips / sentinel corruption on the DEFAULT precision tier, so
        # admission skips straight to f32 until the cooldown re-probes
        self._tier_breakers = BreakerBoard(
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_s)
        self._task: Optional[asyncio.Task] = None
        # The worker pool owns EVERY device-work thread (batches,
        # streams, warms, gate measurements). Batches run under the
        # shared side of the pool's gate lock, gate measurements and
        # warms under the exclusive side, so the gate's two focusing runs
        # and a warm's timed sweep never share the card with lane
        # batches (workers.py). Lanes are (re)started by start() after a
        # stop().
        self.pool = WorkerPool(lanes=config.lanes,
                               inflight_cap=config.inflight_cap)
        self._inflight_tasks: Set[asyncio.Task] = set()

    # -- lifecycle ----------------------------------------------------------
    async def start(self, warm: Sequence[Tuple[SceneConfig, str,
                                               Optional[str]]] = ()) -> None:
        """Spawn the lanes and the batcher task; pre-warm backend caches
        for each (scene, variant, precision) triple so the first real
        requests pay no compile/trace/filter cost."""
        if not self.pool.started:
            self.pool.start()
        for scene, variant, precision in warm:
            key = BatchKey(scene, variant, precision, False)
            await self.pool.run_exclusive(
                self.backend.warm, key, self.config.max_batch)
        self._task = asyncio.create_task(self.batcher.run())

    async def stop(self) -> None:
        """Flush pending batches (earliest-deadline first), join the
        batcher, await every in-flight lane task, and fail requests that
        raced admission behind the shutdown sentinel (their futures
        raise) rather than leaving them pending forever."""
        if self._task is not None:
            self.queue.put_stop()
            await self._task
            self._task = None
        # the batcher has joined, so no new dispatches: one gather over
        # the snapshot covers every in-flight lane task
        tasks = list(self._inflight_tasks)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._inflight_tasks.clear()
        for req in self.queue.drain_nowait():
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("service stopped before execution"))
            self.metrics.observe_failure()
        self.metrics.set_lane_occupancy(self.pool.occupancy())
        self.pool.shutdown()                 # start() re-creates the lanes

    # -- admission ----------------------------------------------------------
    async def _ensure_gate_measured(self, precision: Optional[str]) -> None:
        """Populate the gate cache for ``precision`` off the event loop:
        the first measurement focuses a 256^2 quality scene twice, which
        must not stall the batcher's deadlines or concurrent admissions.
        It runs under the worker pool's EXCLUSIVE lock, serialized
        against every lane. Cached checks stay synchronous."""
        if precision in (None, "f32") or precision in self._gate_cache:
            return
        dev = await self.pool.run_exclusive(
            self._precision_deviation, precision)
        self._gate_cache[precision] = float(dev)

    def _check_gate(self, precision: Optional[str]) -> None:
        """Lookup-only: admission must await _ensure_gate_measured first.
        Measuring here would put two focusing runs on the event-loop
        thread, outside the exclusive lock."""
        if precision in (None, "f32"):
            return
        if precision not in self._gate_cache:
            raise RuntimeError(
                f"SNR gate for {precision!r} consulted before it was "
                "measured (call _ensure_gate_measured first)")
        dev = self._gate_cache[precision]
        if dev > self.config.snr_gate_db:
            self.metrics.observe_gate_reject()
            raise SnrGateViolation(
                f"precision {precision!r}: measured SNR deviation "
                f"{dev:.3f} dB exceeds the {self.config.snr_gate_db} dB "
                "gate")

    async def _admit_precision(self, precision: Optional[str],
                               explicit: bool) -> Optional[str]:
        """Resolve the precision tier a request will actually serve at.

        An EXPLICIT per-request precision keeps the strict contract: a
        tripped gate raises SnrGateViolation (the caller asked for that
        tier by name). The DEFAULT tier degrades instead of erroring —
        a gate trip (or an open "tier:<precision>" breaker, fed by
        runtime sentinel corruption) falls back to the f32 verification
        tier, which never consults the gate. The breaker's cooldown
        re-probes the fast tier so a transient trip does not pin the
        service at f32 forever."""
        if precision in (None, "f32"):
            return precision
        fall = self.config.tier_fallback and not explicit
        breaker = self._tier_breakers.get(f"tier:{precision}")
        if fall and not breaker.allow():
            self.metrics.observe_tier_fallback()
            return "f32"
        await self._ensure_gate_measured(precision)
        try:
            self._check_gate(precision)
        except SnrGateViolation:
            if not fall:
                raise
            breaker.record_failure()
            self.metrics.observe_tier_fallback()
            return "f32"
        return precision

    def _admit(self, req: FocusRequest) -> None:
        """Enqueue, shedding latest-deadline pending work at the bound
        when the arrival's deadline is earlier (EDF admission)."""
        try:
            self.queue.put(req, extra=self.batcher.pending_count())
        except ServiceOverloaded:
            victim = (self.batcher.shed_latest(req.t_deadline, req.priority)
                      if self.config.shed else None)
            if victim is None:
                self.metrics.observe_reject()
                raise
            if not victim.future.done():
                victim.future.set_exception(RequestCancelled(
                    "shed under overload: this request's deadline "
                    f"({'none' if victim.deadline_ms is None else f'{victim.deadline_ms:g} ms'}) "
                    "is the latest in the backlog and an earlier-deadline "
                    "request arrived at the admission bound"))
            self.metrics.observe_shed()
            self.queue.put(req, extra=self.batcher.pending_count())

    async def focus(self, raw, scene: SceneConfig,
                    variant: Optional[str] = None,
                    precision: Optional[str] = None,
                    deadline_ms: Optional[float] = None,
                    priority: int = 0) -> np.ndarray:
        """Submit one scene; resolves to its focused (na, nr) image.

        ``precision=None`` takes the service's default tier
        (``ServiceConfig.precision``, 'bs16' out of the box); pass 'f32'
        explicitly for the verification path. The resolved tier — default
        or per-request — is what the SNR gate checks and what the batcher
        coalesces on.

        ``deadline_ms`` is the completion deadline relative to
        submission: buckets flush earliest-deadline first, a request
        still pending past its deadline is dropped before padding
        (raises RequestCancelled), and under overload the latest-deadline
        pending request is shed to admit earlier-deadline work.
        ``priority`` breaks deadline ties (higher wins). A request
        without a deadline is never dropped, but is the first shed.

        Raises SnrGateViolation (quality gate), ServiceOverloaded
        (backlog at bound, nothing sheddable), or RequestCancelled
        (dropped by deadline or shed) — the first two BEFORE any device
        work — and RuntimeError when the service is not running (not
        started, stopped, or the batcher task died)."""
        if self._task is None or self._task.done():
            raise RuntimeError(
                "service is not running (call start() first; submissions "
                "after stop() are rejected)")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        explicit = precision is not None
        if precision is None:
            precision = self.config.precision
        precision = await self._admit_precision(precision, explicit)
        raw = np.ascontiguousarray(np.asarray(raw, np.complex64))
        if raw.shape != (scene.na, scene.nr):
            raise ValueError(
                f"scene shape {raw.shape} != ({scene.na}, {scene.nr})")
        stream = (self.config.device_budget_bytes is not None
                  and raw.nbytes > self.config.device_budget_bytes)
        loop = asyncio.get_running_loop()
        req = FocusRequest(
            raw=raw, scene=scene, variant=variant or self.config.variant,
            precision=precision, future=loop.create_future(),
            t_submit=now(), stream=stream, deadline_ms=deadline_ms,
            priority=priority)
        self._admit(req)
        self.metrics.observe_submit(self.queue.depth()
                                    + self.batcher.pending_count())
        return await req.future

    # -- dispatch (called by the batcher) ------------------------------------
    def _on_drop(self, req: FocusRequest, reason: str) -> None:
        self.metrics.observe_cancelled(reason)

    async def _dispatch(self, key: BatchKey, reqs: List[FocusRequest]) -> None:
        """The batcher's hand-off: route to a lane, take an in-flight
        slot (parking here is the in-flight-cap backpressure), schedule
        the device work as a background task, return immediately so the
        batcher keeps draining while this batch runs."""
        lane = self.pool.route(key)
        predicted_s = self.pool.predicted_seconds(key, batch=len(reqs))
        await lane.acquire(predicted_s)
        task = asyncio.get_running_loop().create_task(
            self._run_batch(lane, predicted_s, key, reqs))
        self._inflight_tasks.add(task)
        task.add_done_callback(self._inflight_tasks.discard)

    async def _run_batch(self, lane: Lane, predicted_s: float,
                         key: BatchKey, reqs: List[FocusRequest]) -> None:
        """Resilient batch executor: every request in ``reqs`` resolves
        to an image or a TYPED error — a fault never leaves a future
        pending and never silently fails healthy coalesced neighbors.
        Streamed keys serve per scene (each its own failure domain)."""
        t0 = time.perf_counter()
        busy = [0.0]
        try:
            if key.stream:
                for r in reqs:
                    await self._serve_batch(lane, key, [r], busy)
            else:
                await self._serve_batch(lane, key, reqs, busy)
            wall_ms = (time.perf_counter() - t0) * 1e3
            self.metrics.observe_batch(
                len(reqs), wall_ms, streamed=key.stream, lane=lane.name,
                max_batch=None if key.stream else self.config.max_batch)
            self.queue.note_service_time(wall_ms / 1e3 / len(reqs))
        finally:
            lane.release(predicted_s, busy_s=busy[0])
            self.metrics.set_lane_occupancy(self.pool.occupancy())

    def _stall_timeout(self, lane: Lane) -> Optional[float]:
        if self.config.stall_factor is None:
            return None
        return lane.stall_timeout(self.config.stall_factor,
                                  self.config.stall_floor_s)

    async def _attempt(self, lane: Lane, key: BatchKey,
                       reqs: List[FocusRequest]):
        """One dispatch of ``reqs`` on ``lane`` under the stall
        watchdog; returns (images, device seconds)."""
        if key.stream:
            img, secs = await self.pool.run_batch(
                lane, self.backend.execute_streamed, key, reqs[0].raw,
                self.config.stream_strips,
                stall_timeout=self._stall_timeout(lane))
            return [img], secs
        # host staging happens HERE, on the event loop — while other
        # lanes' batches compute on their threads
        batch = np.stack([r.raw for r in reqs])
        images, secs = await self.pool.run_batch(
            lane, self.backend.execute, key, batch,
            stall_timeout=self._stall_timeout(lane))
        return list(images), secs

    def _resolve(self, r: FocusRequest, img) -> None:
        if not r.future.done():
            r.future.set_result(np.asarray(img))
        t_done = now()
        self.metrics.observe_done(
            (t_done - r.t_submit) * 1e3,
            deadline_met=(None if r.deadline_ms is None
                          else t_done <= r.t_deadline))

    def _fail(self, r: FocusRequest, exc: Exception) -> None:
        if not r.future.done():
            r.future.set_exception(exc)
        self.metrics.observe_failure()

    async def _serve_batch(self, lane: Lane, key: BatchKey,
                           reqs: List[FocusRequest], busy: List[float],
                           depth: int = 0) -> None:
        """Serve one failure domain: dispatch, then walk the recovery
        ladder until every request is resolved (image or typed error).

        * a dispatch error (including LaneStalled from the lane
          supervisor) is retried up to ``max_retries`` times with
          seeded-jitter exponential backoff, never scheduled past the
          earliest live deadline in the domain;
        * a domain that exhausts retries with >1 request BISECTS — each
          half recurses independently, so a single poison scene ends as
          a singleton typed error while its neighbors serve;
        * after a successful dispatch the output sentinel checks each
          scene; healthy scenes resolve immediately, corrupted scenes
          re-dispatch on the retry budget — with a reduced default tier
          re-running at f32 (the verification tier) and feeding the
          "tier:<precision>" breaker — and raise OutputCorrupted when
          the budget is spent.

        Never raises: failures land on the request futures."""
        attempt = 0
        while True:
            live = [r for r in reqs if not r.future.done()]
            if not live:
                return
            try:
                images, secs = await self._attempt(lane, key, live)
                busy[0] += secs
            except Exception as e:       # noqa: BLE001 — failure domain edge
                if isinstance(e, LaneStalled):
                    self.metrics.observe_stall()
                self.metrics.observe_dispatch_failure()
                delay = self._retry.budget(
                    attempt, min(r.t_deadline for r in live))
                if delay is not None:
                    attempt += 1
                    self.metrics.observe_retry()
                    await asyncio.sleep(delay)
                    continue
                if (len(live) > 1 and self.config.bisect
                        and depth < _MAX_BISECT_DEPTH):
                    self.metrics.observe_bisect()
                    mid = len(live) // 2
                    await self._serve_batch(lane, key, live[:mid], busy,
                                            depth + 1)
                    await self._serve_batch(lane, key, live[mid:], busy,
                                            depth + 1)
                    return
                if (key.precision not in (None, "f32")
                        and self.config.tier_fallback):
                    # terminal dispatch failure at a reduced tier MUST
                    # record an outcome on the tier breaker: a half-open
                    # probe that dies on this path would otherwise wedge
                    # the breaker half_open forever (no success, no
                    # failure — allow() never admits another probe) and
                    # pin the default tier to f32
                    self._tier_breakers.get(
                        f"tier:{key.precision}").record_failure()
                for r in live:
                    self._fail(r, e)
                return
            # -- per-scene output health --------------------------------
            bad: List[Tuple[FocusRequest, str]] = []
            for r, img in zip(live, images):
                reason = (self._sentinel.check(r.raw, img)
                          if self._sentinel is not None else None)
                if reason is None:
                    self._resolve(r, img)
                else:
                    bad.append((r, reason))
            if key.precision not in (None, "f32") and len(bad) < len(live):
                self._tier_breakers.get(
                    f"tier:{key.precision}").record_success()
            if not bad:
                return
            self.metrics.observe_corrupt(len(bad))
            reqs = [r for r, _ in bad]
            if (key.precision not in (None, "f32")
                    and self.config.tier_fallback):
                # corruption on a reduced tier: re-run at f32 and feed
                # the tier breaker so repeated corruption re-routes
                # admission until the cooldown probe
                self._tier_breakers.get(
                    f"tier:{key.precision}").record_failure()
                key = key._replace(precision="f32")
                self.metrics.observe_tier_fallback(len(bad))
            delay = self._retry.budget(
                attempt, min(r.t_deadline for r in reqs))
            if delay is None:
                for r, reason in bad:
                    self._fail(r, OutputCorrupted(reason))
                return
            attempt += 1
            self.metrics.observe_retry()
            await asyncio.sleep(delay)
