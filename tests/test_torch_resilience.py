"""The port's failure-domain layer on the CPU, at 128^2: circuit
breakers, deadline-aware retry, the output health sentinel, seam-level
fault injection, the tier ladder, poison-batch bisection, lane stall
supervision and the seeded chaos replay (0 lost requests) — the
reference's tests/test_resilience.py on ``LocalBackend(device="cpu")`` —
the port's copy of ``distributed/fault.py`` (tests/test_fault.py's own
tests of it), and the pure-Python policy held to the JAX package's on
the same seeds: the same fault schedule and the same backoff sequence.

Every degraded route returns the image the healthy route would have:
bit-identical for fused1 -> fused3 and for the sharded route -> the
strips (on a mesh of 8 CPU slabs), within 0.1 dB for the bs16 -> f32
precision step. When both kernel tiers fail, the request fails: no tier
serves through a plain PyTorch chain.
"""
import asyncio
import functools
import math
import time

import numpy as np
import pytest
import torch

from repro.service import RetryPolicy as JRetryPolicy
from repro.service import seeded_schedule as jseeded_schedule

from repro_torch.core.sar import build_pipeline, metrics, paper_targets
from repro_torch.core.sar import simulate
from repro_torch.core.sar.geometry import test_scene as make_test_scene
from repro_torch.distributed.fault import (
    FailureInjector,
    PreemptionHandler,
    StragglerWatchdog,
    run_with_restarts,
)
from repro_torch.service import (
    BatchKey,
    BreakerBoard,
    ChaosBackend,
    CircuitBreaker,
    FaultInjector,
    FaultSpec,
    FocusService,
    HealthSentinel,
    LocalBackend,
    OutputCorrupted,
    RequestQueue,
    RetryPolicy,
    ServiceConfig,
    ServiceOverloaded,
    SimulatedFailure,
    SnrGateViolation,
    FocusRequest,
    scene_digest,
    seeded_schedule,
)
from repro_torch.service.faults import SEAMS
from repro_torch.service.resilience import LaneStalled
from repro_torch.service.workers import WorkerPool

CFG = make_test_scene(128)
TARGETS = paper_targets(CFG)
GATE_DB = 0.1


@pytest.fixture(autouse=True, scope="module")
def empty_tuning_cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("tuning") / "autotune_cache.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
        yield


def fast_backend(**kw):
    return LocalBackend(device="cpu", sweep=((None, None),), **kw)


def service(config, backend=None, **kw):
    return FocusService(config, backend=backend or fast_backend(),
                        device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _scene():
    return simulate(CFG, TARGETS, device="cpu").numpy()


def scene():
    return _scene().copy()


def reference(variant="fused3", raw=None, **kw):
    raw = scene() if raw is None else raw
    return build_pipeline(CFG, variant, device="cpu", **kw).run(
        torch.from_numpy(np.ascontiguousarray(raw))).numpy()


# ---------------------------------------------------------------------------
# distributed/fault.py (tests/test_fault.py's own tests of it)
# ---------------------------------------------------------------------------

def test_injector_fires_once():
    inj = FailureInjector(at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)  # second pass: already fired


def test_watchdog_flags_straggler():
    wd = StragglerWatchdog(factor=3.0)
    for i in range(8):
        wd.record(i, 0.1)
    assert wd.record(8, 1.0) is True
    assert wd.flagged and wd.flagged[0][0] == 8


def test_run_with_restarts_restores_after_a_failure_and_preemption():
    inj = FailureInjector(at_steps=(2,))
    restores = []

    def restore():
        restores.append(len(restores))
        return 0

    def train(state):
        for step in range(state, 4):
            inj.check(step)
        return 4

    assert run_with_restarts(train, restore) == (4, 1)
    assert restores == [0, 1]
    pre = PreemptionHandler(install=False)
    assert not pre.should_stop
    pre.trigger()
    assert pre.should_stop


# ---------------------------------------------------------------------------
# CircuitBreaker / RetryPolicy / HealthSentinel units
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_circuit_breaker_opens_after_threshold_and_half_open_probes():
    clk = _Clock()
    br = CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clk)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.allow(), "below threshold: still closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clk.t = 9.9
    assert not br.allow(), "cooldown not elapsed"
    clk.t = 10.0
    assert br.allow(), "cooldown elapsed: half-open probe admitted"
    assert br.state == "half_open"
    assert not br.allow(), "only ONE probe while half-open"
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_circuit_breaker_half_open_failure_rearms_cooldown():
    clk = _Clock()
    br = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    clk.t = 5.0
    assert br.allow()
    br.record_failure()                   # the probe failed
    assert br.state == "open" and br.trips == 2
    clk.t = 9.0
    assert not br.allow(), "cooldown restarted at the probe failure"
    clk.t = 10.0
    assert br.allow()


def test_circuit_breaker_vanished_probe_reprobes_after_cooldown():
    clk = _Clock()
    br = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
    br.record_failure()
    clk.t = 5.0
    assert br.allow(), "cooldown elapsed: probe admitted"
    assert not br.allow(), "probe in flight"
    clk.t = 10.0
    assert br.allow(), "vanished probe: a fresh probe is admitted"
    assert not br.allow(), "again only ONE probe at a time"
    br.record_success()
    assert br.state == "closed"


def test_breaker_board_is_per_name_and_snapshots():
    board = BreakerBoard(threshold=1, cooldown_s=99.0, clock=_Clock())
    board.get("route:a").record_failure()
    assert not board.get("route:a").allow()
    assert board.get("route:b").allow(), "breakers are per route"
    snap = board.snapshot()
    assert snap["route:a"]["state"] == "open"
    assert snap["route:b"]["state"] == "closed"


def test_retry_policy_is_seeded_deterministic_and_bounded():
    a = RetryPolicy(max_retries=3, backoff_s=0.01, seed=7, clock=_Clock())
    b = RetryPolicy(max_retries=3, backoff_s=0.01, seed=7, clock=_Clock())
    da = [a.budget(i) for i in range(4)]
    assert da == [b.budget(i) for i in range(4)], "same seed, same jitter"
    assert all(d > 0 for d in da[:3])
    assert da[1] > da[0], "exponential growth dominates jitter"
    assert da[3] is None, "budget exhausted at max_retries"


def test_retry_policy_never_schedules_past_deadline():
    clk = _Clock(100.0)
    pol = RetryPolicy(max_retries=5, backoff_s=1.0, jitter=0.0, clock=clk)
    assert pol.budget(0, t_deadline=math.inf) == pytest.approx(1.0)
    assert pol.budget(0, t_deadline=101.0) is None
    assert pol.budget(0, t_deadline=101.5) == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 7, 20260808])
def test_retry_policy_backoff_matches_the_reference(seed):
    """The same seed draws the same jittered backoff sequence in both
    packages (chaos replays are deterministic across them)."""
    kw = dict(max_retries=6, backoff_s=0.025, seed=seed)
    ours = RetryPolicy(clock=_Clock(), **kw)
    theirs = JRetryPolicy(clock=_Clock(), **kw)
    assert [ours.budget(i) for i in range(7)] == \
        [theirs.budget(i) for i in range(7)]


def test_health_sentinel_flags_corruption_modes_and_passes_real_images():
    sent = HealthSentinel(envelope=1e6)
    raw = scene()
    img = reference()
    assert sent.check(raw, img) is None, "healthy pipeline output passes"
    nan = img.copy()
    nan.flat[0] = np.nan
    assert "non-finite" in sent.check(raw, nan)
    inf = img.copy()
    inf.flat[3] = np.inf
    assert "non-finite" in sent.check(raw, inf)
    assert "all-zero" in sent.check(raw, np.zeros_like(img))
    assert "envelope" in sent.check(raw, img * 1e9)
    assert sent.check(np.zeros_like(raw), np.zeros_like(img)) is None


def test_retry_after_hint_clamped_to_positive_floor():
    async def main():
        q = RequestQueue(1)
        for _ in range(200):
            q.note_service_time(1e-12)
        assert q.retry_after_hint(0) >= 1e-3
        loop = asyncio.get_running_loop()
        req = FocusRequest(raw=np.zeros((2, 2), np.complex64), scene=CFG,
                           variant="fused3", precision=None,
                           future=loop.create_future(), t_submit=0.0)
        q.put(req)
        with pytest.raises(ServiceOverloaded) as ei:
            q.put(req)
        assert ei.value.retry_after_hint > 0
        assert "retry_after_hint=0.000s" not in str(ei.value)

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Fault injector / seeded schedule
# ---------------------------------------------------------------------------

def test_seeded_schedule_is_deterministic_and_covers_seams():
    seams = ("dispatch_error", "nan_output", "lane_hang", "straggler")
    a = seeded_schedule(20260808, 12, seams)
    assert a == seeded_schedule(20260808, 12, seams), "same seed"
    assert a != seeded_schedule(1, 12, seams), "different placement"
    assert sorted(s.seam for s in a) == sorted(seams)
    ordinals = [s.at_dispatch for s in a]
    assert len(set(ordinals)) == len(ordinals), "distinct ordinals"
    assert min(ordinals) >= 2, "earliest dispatches stay clean"


@pytest.mark.parametrize("n,seams", [
    (7, ("dispatch_error", "nan_output", "lane_hang")),
    (12, ("dispatch_error", "nan_output", "lane_hang", "straggler")),
])
def test_seeded_schedule_matches_the_reference(n, seams):
    """The chaos replay's schedule is the reference's, fault for fault."""
    ours = seeded_schedule(20260808, n, seams)
    theirs = jseeded_schedule(20260808, n, seams)
    assert [(s.seam, s.at_dispatch, s.delay_s) for s in ours] == \
        [(s.seam, s.at_dispatch, s.delay_s) for s in theirs]


def test_fault_spec_validates_seams():
    with pytest.raises(ValueError):
        FaultSpec(seam="nope", at_dispatch=0)
    with pytest.raises(ValueError):
        FaultSpec(seam="dispatch_error")       # needs at_dispatch
    with pytest.raises(ValueError):
        FaultSpec(seam="poison_scene")         # needs a digest
    assert set(SEAMS) >= {"dispatch_error", "nan_output", "lane_hang"}


def test_ordinal_fault_not_shadowed_by_poison_hit():
    raw = scene()
    inj = FaultInjector([
        FaultSpec(seam="dispatch_error", at_dispatch=0),
        FaultSpec(seam="poison_scene", match=scene_digest(raw))])
    with pytest.raises(SimulatedFailure, match="dispatch error"):
        inj.begin([raw])                   # ordinal fault wins the tie
    with pytest.raises(SimulatedFailure, match="poison"):
        inj.begin([raw])                   # the poison re-fires next
    assert inj.seams_fired() == ["dispatch_error", "poison_scene"]


def test_chaos_backend_injects_dispatch_error_once_then_recovers():
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="dispatch_error", at_dispatch=0)]))
    key = BatchKey(CFG, "fused3", None, False)
    raw = scene()[None]
    with pytest.raises(SimulatedFailure):
        backend.execute(key, raw)
    out = backend.execute(key, raw)        # ordinal 1: clean
    assert np.array_equal(out[0], reference())
    assert backend.injector.seams_fired() == ["dispatch_error"]


def test_chaos_backend_nan_output_corrupts_scene_zero_only():
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="nan_output", at_dispatch=0)]))
    key = BatchKey(CFG, "fused3", None, False)
    raw = scene()
    out = backend.execute(key, np.stack([raw, raw * 0.5]))
    assert not np.all(np.isfinite(out[0]))
    assert np.all(np.isfinite(out[1])), "coalesced neighbor stays healthy"


# ---------------------------------------------------------------------------
# Service-level recovery: retry, sentinel, bisection, lane supervision
# ---------------------------------------------------------------------------

def _svc_config(**kw):
    base = dict(max_batch=4, max_delay_ms=20.0, precision=None,
                lanes=1, inflight_cap=1, max_retries=2,
                retry_backoff_ms=5.0, stall_floor_s=30.0)
    base.update(kw)
    return ServiceConfig(**base)


def test_service_retries_injected_dispatch_error_transparently():
    raw = scene()
    ref = reference()
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="dispatch_error", at_dispatch=0)]))

    async def main():
        svc = service(_svc_config(), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        outs = await asyncio.gather(*[svc.focus(raw, CFG)
                                      for _ in range(3)])
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    for o in outs:
        assert np.array_equal(o, ref), "retried batch stays bit-identical"
    assert snap["dispatch_failures"] == 1
    assert snap["retries"] == 1
    assert snap["failed"] == 0 and snap["completed"] == 3


def test_service_sentinel_turns_nan_output_into_retry_then_success():
    raw = scene()
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="nan_output", at_dispatch=0)]))

    async def main():
        svc = service(_svc_config(), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        outs = await asyncio.gather(svc.focus(raw, CFG),
                                    svc.focus(raw * 0.5, CFG))
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert np.array_equal(outs[0], reference())
    assert np.array_equal(outs[1], reference(raw=raw * 0.5))
    assert snap["corrupted"] == 1, "exactly the injected scene flagged"
    assert snap["retries"] >= 1
    assert snap["failed"] == 0


def test_service_sentinel_exhausted_raises_output_corrupted():
    raw = scene()

    class _AlwaysNan:
        def warm(self, key, max_batch=4):
            pass

        def execute(self, key, batch):
            return np.full_like(batch, np.nan)

        def execute_streamed(self, key, raw, strips=4):
            return np.full_like(raw, np.nan)

    async def main():
        svc = service(_svc_config(max_retries=1, bisect=False), _AlwaysNan())
        await svc.start()
        with pytest.raises(OutputCorrupted):
            await svc.focus(raw, CFG)
        await svc.stop()
        return svc.metrics.snapshot()

    snap = asyncio.run(main())
    assert snap["corrupted"] >= 1
    assert snap["failed"] == 1


def test_poison_batch_bisection_isolates_one_bad_scene():
    raw = scene()
    poison = raw * 0.25
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="poison_scene",
                                 match=scene_digest(poison))]))
    ref = reference()

    async def main():
        svc = service(_svc_config(max_retries=0, max_delay_ms=100.0),
                      backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        outs = await asyncio.gather(
            svc.focus(raw, CFG), svc.focus(poison.copy(), CFG),
            svc.focus(raw, CFG), svc.focus(raw, CFG),
            return_exceptions=True)
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert np.array_equal(outs[0], ref)
    assert isinstance(outs[1], SimulatedFailure), \
        "the poison request fails alone, with the typed error"
    assert np.array_equal(outs[2], ref)
    assert np.array_equal(outs[3], ref)
    assert snap["bisections"] >= 1
    assert snap["completed"] == 3 and snap["failed"] == 1


def test_lane_stall_watchdog_restarts_lane_and_retries():
    raw = scene()
    ref = reference()
    injector = FaultInjector([FaultSpec(seam="lane_hang", at_dispatch=1)],
                             hang_timeout_s=60.0)
    backend = ChaosBackend(fast_backend(), injector)

    async def main():
        svc = service(_svc_config(stall_factor=3.0, stall_floor_s=1.0,
                                  max_retries=2), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        first = await svc.focus(raw, CFG)       # ordinal 0: clean
        second = await svc.focus(raw, CFG)      # ordinal 1: hangs
        # exclusive-side work is still possible (the stalled hold on the
        # gate lock was force-released)
        ok = await asyncio.wait_for(
            svc.pool.run_exclusive(lambda: "ok"), timeout=10.0)
        pool_snap = svc.pool.snapshot()
        await svc.stop()
        return first, second, ok, pool_snap, svc.metrics.snapshot()

    try:
        first, second, ok, pool_snap, snap = asyncio.run(main())
    finally:
        injector.release_hangs()
    assert np.array_equal(first, ref)
    assert np.array_equal(second, ref), \
        "the retried batch (fresh lane thread) stays bit-identical"
    assert ok == "ok"
    assert snap["lane_stalls"] == 1
    assert snap["failed"] == 0
    lane = pool_snap["fused0"]
    assert lane["stalls"] == 1 and lane["generation"] == 1


def test_stall_clock_counts_running_time_not_queue_wait():
    async def main():
        pool = WorkerPool(lanes=1, inflight_cap=2)
        pool.start()
        lane = pool.batch_lanes[0]
        ta = asyncio.ensure_future(
            pool.run_batch(lane, time.sleep, 1.2, stall_timeout=5.0))
        await asyncio.sleep(0.1)        # A is on the worker thread
        tb = asyncio.ensure_future(
            pool.run_batch(lane, lambda: "ok", stall_timeout=0.3))
        (_, secs_a), (out_b, secs_b) = await asyncio.gather(ta, tb)
        snap = (lane.stalls, lane.generation)
        pool.shutdown()
        return out_b, secs_a, secs_b, snap

    out_b, secs_a, secs_b, (stalls, generation) = asyncio.run(main())
    assert out_b == "ok", "queued batch served after its sibling"
    assert stalls == 0 and generation == 0, \
        "queue wait must not trip the watchdog"
    assert secs_a > 1.0
    assert secs_b < 0.3


def test_queued_handoff_cancelled_by_restart_resolves_not_hangs():
    raw = scene()
    ref = reference()
    injector = FaultInjector([FaultSpec(seam="lane_hang", at_dispatch=1)],
                             hang_timeout_s=60.0)
    backend = ChaosBackend(fast_backend(), injector)

    async def main():
        svc = service(_svc_config(max_batch=1, inflight_cap=2,
                                  stall_factor=3.0, stall_floor_s=1.0,
                                  max_retries=2, max_delay_ms=5.0), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        first = await svc.focus(raw, CFG)       # ordinal 0: warms EWMA
        outs = await asyncio.wait_for(
            asyncio.gather(svc.focus(raw, CFG), svc.focus(raw, CFG)),
            timeout=60.0)
        await svc.stop()
        return first, outs, svc.metrics.snapshot(), svc.pool.snapshot()

    try:
        first, outs, snap, pool_snap = asyncio.run(main())
    finally:
        injector.release_hangs()
    assert np.array_equal(first, ref)
    for out in outs:
        assert np.array_equal(out, ref)
    assert snap["failed"] == 0
    assert pool_snap["fused0"]["stalls"] >= 1


def test_tier_probe_dispatch_failure_reopens_breaker():
    raw = scene()
    clk = _Clock()
    backend = ChaosBackend(
        fast_backend(),
        FaultInjector([FaultSpec(seam="dispatch_error", at_dispatch=0)]))

    async def main():
        svc = service(_svc_config(precision="bs16", max_retries=0,
                                  bisect=False), backend,
                      precision_deviation=lambda p: 0.0)
        svc._tier_breakers = BreakerBoard(threshold=1, cooldown_s=10.0,
                                          clock=clk)
        await svc.start(warm=[(CFG, "fused3", "bs16")])
        br = svc._tier_breakers.get("tier:bs16")
        br.record_failure()                # tier breaker opens
        assert br.state == "open"
        clk.t = 10.0                       # cooldown over: probe admitted
        with pytest.raises(SimulatedFailure):
            await svc.focus(raw, CFG)      # the probe dies mid-dispatch
        assert br.state == "open"
        clk.t = 20.0                       # next cooldown: fresh probe
        out = await svc.focus(raw, CFG)    # ordinal 1: clean
        assert br.state == "closed"
        await svc.stop()
        return out

    assert np.array_equal(asyncio.run(main()), reference(precision="bs16"))


# ---------------------------------------------------------------------------
# The tier ladder (the degraded-route counterpart of route invisibility)
# ---------------------------------------------------------------------------

class _Boom:
    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        raise RuntimeError("injected tier failure")


@pytest.mark.parametrize("precision", [None, "bf16", "bs16"])
def test_fallback_fused1_to_fused3_bit_identical(precision):
    backend = fast_backend()
    key = BatchKey(CFG, "fused3", precision, False)
    assert backend._route_variant(key) == "fused1", \
        "128^2 fits one block: the megakernel tier is tier 0"
    boom = _Boom()
    backend._fns[(key, "fused1")] = boom       # tier 0 launches fail
    out = backend.execute(key, scene()[None])
    kw = {} if precision is None else {"precision": precision}
    assert boom.calls == 1
    assert np.array_equal(out[0], reference(**kw))
    assert backend.fallbacks["serve:plan"] == 1


def test_fallback_breaker_opens_then_half_open_probe_recovers():
    clk = _Clock()
    backend = fast_backend(
        breakers=BreakerBoard(threshold=2, cooldown_s=10.0, clock=clk))
    key = BatchKey(CFG, "fused3", None, False)
    boom = _Boom()
    real = backend._fn(key, "fused1")
    backend._fns[(key, "fused1")] = boom
    raw = scene()[None]
    ref = reference()
    name = f"fused1:fused1:{CFG.na}x{CFG.nr}:None"
    for _ in range(2):                         # trip the breaker
        assert np.array_equal(backend.execute(key, raw)[0], ref)
    assert backend.breakers.get(name).state == "open"
    backend.execute(key, raw)
    assert boom.calls == 2, "open breaker: fused1 not even attempted"
    clk.t = 10.0                               # cooldown elapses
    backend._fns[(key, "fused1")] = real       # the route healed
    assert np.array_equal(backend.execute(key, raw)[0], ref)
    assert backend.breakers.get(name).state == "closed"


def test_fallback_defused_last_resort_serves_when_both_fused_tiers_fail():
    """fused1 AND fused3 failing raises the last tier's error: the ladder
    only moves between kernel routes, and nothing below fused3 launches
    the kernels (no defused, plain PyTorch tier)."""
    backend = fast_backend()
    key = BatchKey(CFG, "fused3", None, False)
    assert [v for _, v in backend._execute_tiers(key)] == ["fused1",
                                                          "fused3"]
    first, last = _Boom(), _Boom()
    backend._fns[(key, "fused1")] = first
    backend._fns[(key, "fused3")] = last
    with pytest.raises(RuntimeError, match="injected tier failure"):
        backend.execute(key, scene()[None])
    assert (first.calls, last.calls) == (1, 1)
    assert not any(k.startswith("serve:") for k in backend.fallbacks)
    name = f"plan:fused3:{CFG.na}x{CFG.nr}:None"
    assert backend.breakers.get(name).failures == 1


def test_fallback_sharded_to_local_stream_bit_identical(monkeypatch):
    """The big-scene sharded route failing mid-serve falls back to the
    single-device strip path, bit-identical (same math, same precision,
    a different partitioning); both routes launch the kernels."""
    backend = fast_backend()
    key = BatchKey(CFG, "fused3", None, True)
    monkeypatch.setattr(backend, "_sharded_twin", lambda k: "fused1")
    boom = _Boom()
    monkeypatch.setattr(backend, "_sharded_fn", lambda k: boom)
    raw = scene()
    out = backend.execute_streamed(key, raw, strips=4)
    ref = build_pipeline(CFG, "fused3", device="cpu").run_streamed(
        raw, strips=4)
    assert boom.calls == 1
    assert np.array_equal(out, ref)
    assert backend.fallbacks["serve:local_stream"] == 1


def test_a_megakernel_that_raises_on_the_mesh_falls_back_to_strips(
        monkeypatch):
    """On a real 8-slab mesh: a megakernel launch that raises in the
    sharded route trips its breaker and the strips serve the scene; once
    the breaker is open the route is skipped (``skip:sharded``)."""
    from repro_torch.core.sar.distributed import make_sar_mesh
    from repro_torch.kernels import ops

    big = make_test_scene(256)
    raw = simulate(big, paper_targets(big), device="cpu").numpy()
    backend = fast_backend(
        mesh=make_sar_mesh(devices=[torch.device("cpu")] * 8),
        breakers=BreakerBoard(threshold=1, cooldown_s=60.0))
    key = BatchKey(big, "fused3", None, True)
    assert backend._sharded_twin(key) == "fused1"

    def broken(*a, **k):
        raise RuntimeError("megakernel launch failed")
    monkeypatch.setattr(ops, "mega_spectral_op", broken)
    ref = build_pipeline(big, "fused3", device="cpu").run_streamed(raw)
    assert np.array_equal(backend.execute_streamed(key, raw), ref)
    assert np.array_equal(backend.execute_streamed(key, raw), ref)
    assert backend.fallbacks["serve:local_stream"] == 1
    assert backend.fallbacks["skip:sharded"] == 1


def test_a_kernel_that_raises_falls_through_the_ladder(monkeypatch):
    """A launch that raises inside the kernel wrapper (a kernel that does
    not build or launch) is a tier failure like any other: the megakernel
    raising serves through fused3's launches, bit for bit."""
    from repro_torch.kernels import ops

    def broken(*a, **k):
        raise RuntimeError("megakernel launch failed")
    monkeypatch.setattr(ops, "mega_spectral_op", broken)
    backend = fast_backend()
    key = BatchKey(CFG, "fused3", None, False)
    out = backend.execute(key, scene()[None])
    assert np.array_equal(out[0], reference())
    assert backend.fallbacks["serve:plan"] == 1


def test_a_strip_launch_that_raises_fails_the_streamed_request(monkeypatch):
    """The stream lane has one route, the strips through the spectral
    kernel: a launch that raises there reaches the caller, and no other
    route serves the scene."""
    from repro_torch.kernels import ops

    backend = fast_backend()
    key = BatchKey(CFG, "fused3", None, True)
    assert np.array_equal(backend.execute_streamed(key, scene(), strips=4),
                          reference())

    def broken(*a, **k):
        raise RuntimeError("spectral launch failed")
    monkeypatch.setattr(ops, "spectral_op", broken)
    with pytest.raises(RuntimeError, match="spectral launch failed"):
        backend.execute_streamed(key, scene(), strips=4)
    assert not backend.fallbacks


def test_gate_trip_on_default_tier_falls_back_to_f32():
    raw = scene()
    ref_f32 = reference()

    async def main():
        svc = service(ServiceConfig(max_batch=2, max_delay_ms=20.0,
                                    precision="bs16", lanes=1),
                      precision_deviation=lambda p: 0.5)
        await svc.start()
        out = await svc.focus(raw, CFG)          # default tier: degrades
        with pytest.raises(SnrGateViolation):
            await svc.focus(raw, CFG, precision="bs16")  # explicit: raises
        await svc.stop()
        return out, svc.metrics.snapshot()

    out, snap = asyncio.run(main())
    assert np.array_equal(out, ref_f32)
    assert snap["tier_fallbacks"] >= 1
    assert snap["gate_rejected"] >= 1
    rep = metrics.compare_pipelines(out, reference(precision="bs16"), CFG,
                                    TARGETS)
    assert max(rep["snr_delta_db"]) <= GATE_DB


def test_gate_trip_breaker_skips_measurement_after_threshold():
    calls = []

    def deviation(p):
        calls.append(p)
        return 0.5

    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=1, max_delay_ms=5.0,
                                    precision="bs16", lanes=1,
                                    breaker_threshold=2,
                                    breaker_cooldown_s=3600.0),
                      precision_deviation=deviation)
        await svc.start()
        for _ in range(4):
            await svc.focus(raw, CFG)
        await svc.stop()
        return svc.metrics.snapshot()

    snap = asyncio.run(main())
    assert len(calls) == 1, "deviation measured once (gate cache)"
    assert snap["tier_fallbacks"] == 4
    assert snap["completed"] == 4


# ---------------------------------------------------------------------------
# Mini chaos replay: 0 lost requests across 3 seams
# ---------------------------------------------------------------------------

def test_chaos_replay_loses_no_requests():
    """A seeded schedule firing dispatch_error + nan_output + lane_hang
    over a request stream leaves NO lost request — every future resolves
    to the bit-identical image or a typed error."""
    raw = scene()
    ref = reference()
    injector = FaultInjector(
        seeded_schedule(20260808, 7,
                        ("dispatch_error", "nan_output", "lane_hang")),
        hang_timeout_s=60.0)
    backend = ChaosBackend(fast_backend(), injector)

    async def main():
        svc = service(_svc_config(max_batch=2, lanes=2, inflight_cap=1,
                                  stall_factor=3.0, stall_floor_s=1.5,
                                  max_retries=2), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        outs = await asyncio.gather(
            *[svc.focus(raw, CFG) for _ in range(14)],
            return_exceptions=True)
        await svc.stop()
        return outs, svc.metrics.snapshot()

    try:
        outs, snap = asyncio.run(main())
    finally:
        injector.release_hangs()
    assert len(injector.seams_fired()) == 3, injector.seams_fired()
    lost = sum(1 for o in outs
               if not (isinstance(o, np.ndarray) and np.array_equal(o, ref))
               and not isinstance(o, (SimulatedFailure, OutputCorrupted,
                                      LaneStalled)))
    assert lost == 0, f"{lost} lost requests: {outs}"
    typed_errors = sum(1 for o in outs if isinstance(o, Exception))
    assert snap["completed"] == 14 - typed_errors
    assert snap["completed"] >= 11
