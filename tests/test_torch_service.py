"""The port's focusing service (``repro_torch.service``) on the CPU, at
128^2: coalescing bit-identity, bucket padding, deadline flush, deadlines,
shedding and backpressure, lanes, the precision SNR gate and the bs16
default tier, the route-invisibility matrix, the over-budget stream
route, the metrics document — the reference's tests/test_service.py on
``LocalBackend(device="cpu")`` — and the port's service held to the JAX
package's service on the same numpy scene (|dSNR| <= 0.1 dB).

Inside the port a served image is held bit for bit (``np.array_equal``)
to the port's own pipeline on the same scene. The sharded backend and its
8-device tests are not ported (ROADMAP.md Queue 1, item 5).
"""
import asyncio
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

from benchmarks.common import validate_bench_doc, validate_bench_file
from repro.core.sar import metrics as jmetrics
from repro.core.sar import paper_targets as jtargets
from repro.core.sar import simulate_cached as jsimulate_cached
from repro.core.sar.geometry import test_scene as make_jscene
from repro.service import FocusService as JFocusService
from repro.service import LocalBackend as JLocalBackend
from repro.service import ServiceConfig as JServiceConfig

from repro_torch.core.sar import build_pipeline, paper_targets, simulate
from repro_torch.core.sar import scene_from_dict
from repro_torch.core.sar.geometry import test_scene as make_test_scene
from repro_torch.kernels import ops
from repro_torch.service import (
    BatchKey,
    FocusRequest,
    FocusService,
    LocalBackend,
    MicroBatcher,
    RequestCancelled,
    RequestQueue,
    ServiceConfig,
    ServiceOverloaded,
    ShardedBackend,
    SnrGateViolation,
    WorkerPool,
)
from repro_torch.service.queue import now as svc_now

CFG = make_test_scene(128)
TARGETS = paper_targets(CFG)
GATE_DB = 0.1


@pytest.fixture(autouse=True, scope="module")
def empty_tuning_cache(tmp_path_factory):
    """Compiles and warms here read and write a tuning cache of this
    module's own, never the user's."""
    path = tmp_path_factory.mktemp("tuning") / "autotune_cache.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
        yield


def fast_backend(**kw):
    # single-config backend: tests don't need the warm-time block sweep
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
# The card
# ---------------------------------------------------------------------------

def test_service_and_backend_raise_without_a_card(monkeypatch):
    """No device named is the CUDA card: without one the service and its
    backend raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FocusService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FocusService(ServiceConfig(), backend=fast_backend())


def test_sharded_backend_is_refused_naming_its_queue_item():
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        ShardedBackend()
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        FocusService(ServiceConfig(backend="sharded"), device="cpu")


# ---------------------------------------------------------------------------
# Coalescing semantics
# ---------------------------------------------------------------------------

def test_coalesced_batch_bit_identical_to_per_request_run():
    """Four requests coalesced into ONE (4, na, nr) launch sequence
    reproduce per-request Pipeline.run bit for bit."""
    raw = scene()
    ref = reference()
    ref_half = reference(raw=raw * 0.5)

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=500.0,
                                    precision=None))
        await svc.start()
        outs = await asyncio.gather(
            svc.focus(raw, CFG), svc.focus(raw * 0.5, CFG),
            svc.focus(raw, CFG), svc.focus(raw, CFG))
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert snap["batch_size_hist"] == {4: 1}, snap  # actually coalesced
    assert np.array_equal(outs[0], ref)
    assert np.array_equal(outs[1], ref_half)
    assert np.array_equal(outs[2], ref)
    assert np.array_equal(outs[3], ref)


def test_partial_batch_pads_to_bucket_bit_identical():
    """A 3-request batch pads to the B=4 bucket; the zero pad scene does
    not perturb the real scenes' images."""
    raw = scene()
    ref = reference()
    calls = []
    backend = fast_backend()
    inner = backend._fn

    def spy(key, variant=None):
        f = inner(key, variant)
        return lambda x: calls.append(tuple(x.shape)) or f(x)
    backend._fn = spy

    async def main():
        svc = service(ServiceConfig(max_batch=3, max_delay_ms=500.0,
                                    precision=None), backend)
        await svc.start()
        outs = await asyncio.gather(*[svc.focus(raw, CFG) for _ in range(3)])
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert snap["batch_size_hist"] == {3: 1}
    assert calls == [(4, CFG.na, CFG.nr)], "padded to the B=4 bucket"
    for o in outs:
        assert np.array_equal(o, ref)


def test_deadline_flush_fires_for_partial_batch():
    """Two requests under max_batch=8 do not wait forever: the max_delay
    deadline flushes the partial bucket."""
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=8, max_delay_ms=50.0,
                                    precision=None))
        await svc.start()
        t0 = time.monotonic()
        outs = await asyncio.gather(svc.focus(raw, CFG),
                                    svc.focus(raw, CFG))
        elapsed = time.monotonic() - t0
        await svc.stop()
        return outs, elapsed, svc.metrics.snapshot()

    outs, elapsed, snap = asyncio.run(main())
    assert snap["batch_size_hist"] == {2: 1}, snap
    assert len(outs) == 2
    assert elapsed < 30.0


def test_requests_with_different_keys_do_not_coalesce():
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=50.0,
                                    precision=None))
        await svc.start()
        a, b = await asyncio.gather(
            svc.focus(raw, CFG, variant="fused3"),
            svc.focus(raw, CFG, variant="omegak"))
        await svc.stop()
        return a, b, svc.metrics.snapshot()

    a, b, snap = asyncio.run(main())
    assert snap["batch_size_hist"] == {1: 2}, snap
    assert np.array_equal(a, reference("fused3"))
    assert np.array_equal(b, reference("omegak"))


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------

class _GatedBackend:
    """Backend that blocks until released — holds a batch in flight while
    the queue fills behind it."""

    def __init__(self):
        self.release = threading.Event()

    def warm(self, key, max_batch=4):
        pass

    def execute(self, key, batch):
        assert self.release.wait(30)
        return np.zeros_like(batch)

    def execute_streamed(self, key, raw, strips=4):
        assert self.release.wait(30)
        return np.zeros_like(raw)


def test_backpressure_rejects_past_queue_bound():
    """The admission bound covers the TOTAL pre-dispatch backlog: t1 holds
    the one lane slot, t2's flush parks awaiting it (backlog 1), t3 sits
    in the queue (backlog 2 = bound): the fourth submit is rejected."""
    raw = scene()
    backend = _GatedBackend()

    async def main():
        svc = service(
            ServiceConfig(max_batch=1, max_queue=2, precision=None,
                          lanes=1, inflight_cap=1,
                          sentinel=False),   # stub returns zero images
            backend)
        await svc.start()
        t1 = asyncio.ensure_future(svc.focus(raw, CFG))
        await asyncio.sleep(0.1)        # batch 1 now executing (blocked)
        t2 = asyncio.ensure_future(svc.focus(raw, CFG))
        t3 = asyncio.ensure_future(svc.focus(raw, CFG))
        await asyncio.sleep(0.1)        # backlog now at bound (2)
        with pytest.raises(ServiceOverloaded) as exc_info:
            await svc.focus(raw, CFG)
        backend.release.set()
        outs = await asyncio.gather(t1, t2, t3)
        await svc.stop()
        return outs, exc_info.value, svc.metrics.snapshot()

    outs, err, snap = asyncio.run(main())
    assert len(outs) == 3
    assert err.depth == 2 and err.bound == 2
    assert snap["rejected"] == 1
    assert snap["completed"] == 3


def test_service_overloaded_carries_depth_bound_and_retry_hint():
    async def main():
        q = RequestQueue(2)
        loop = asyncio.get_running_loop()

        def mk():
            return FocusRequest(
                raw=np.zeros((2, 2), np.complex64), scene=CFG,
                variant="fused3", precision=None,
                future=loop.create_future(), t_submit=svc_now())

        q.put(mk())
        q.put(mk())
        with pytest.raises(ServiceOverloaded) as ei:
            q.put(mk())
        err = ei.value
        assert err.depth == 2 and err.bound == 2
        assert err.retry_after_hint == pytest.approx(q.retry_after_hint(2))
        assert err.retry_after_hint > 0
        assert "depth 2 >= bound 2" in str(err)
        with pytest.raises(ServiceOverloaded) as e2:
            q.put(mk(), extra=5)
        assert e2.value.depth == 7
        h0 = q.retry_after_hint(2)
        q.note_service_time(1.0)
        assert q.retry_after_hint(2) > h0

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Continuous batching, deadlines, worker pool
# ---------------------------------------------------------------------------

class _RecordingBackend:
    """Delegating backend recording the concurrency of execute calls."""

    def __init__(self, inner, delay: float = 0.0):
        self.inner = inner
        self.delay = delay
        self._lock = threading.Lock()
        self._active = 0
        self.max_active = 0

    def warm(self, key, max_batch=4):
        self.inner.warm(key, max_batch)

    def execute(self, key, batch):
        with self._lock:
            self._active += 1
            self.max_active = max(self.max_active, self._active)
        try:
            if self.delay:
                time.sleep(self.delay)
            return self.inner.execute(key, batch)
        finally:
            with self._lock:
                self._active -= 1

    def execute_streamed(self, key, raw, strips=4):
        return self.inner.execute_streamed(key, raw, strips)


def _mk_req(loop, variant="fused3", deadline_ms=None, priority=0):
    return FocusRequest(
        raw=np.zeros((2, 2), np.complex64), scene=CFG, variant=variant,
        precision=None, future=loop.create_future(), t_submit=svc_now(),
        deadline_ms=deadline_ms, priority=priority)


@pytest.mark.parametrize("case", ["stop_mid_drain", "hot_competing_key"])
def test_batcher_flushes_earliest_deadline_first(case):
    """EDF across buckets, both when STOP is dequeued mid-drain (the
    shutdown flush walks the buckets in deadline order, not insertion
    order) and against a hotter key whose requests carry no deadline."""

    async def main():
        q = RequestQueue(64)
        order = []

        async def execute(key, reqs):
            order.append(key.variant)
            for r in reqs:
                r.future.set_result(None)

        loop = asyncio.get_running_loop()
        if case == "stop_mid_drain":
            b = MicroBatcher(q, execute, max_batch=8, max_delay_ms=1000.0)
            q.put(_mk_req(loop, "fused3", deadline_ms=500.0))
            q.put(_mk_req(loop, "omegak", deadline_ms=50.0))
        else:
            b = MicroBatcher(q, execute, max_batch=8, max_delay_ms=0.0)
            for _ in range(3):
                q.put(_mk_req(loop, "fused3"))
            q.put(_mk_req(loop, "omegak", deadline_ms=80.0))
        q.put_stop()
        await b.run()
        return order

    assert asyncio.run(main()) == ["omegak", "fused3"]


def test_max_batch_one_degenerates_to_sequential_bit_identical():
    raw = scene()
    refs = [reference(), reference(raw=raw * 0.5)]

    async def main():
        svc = service(ServiceConfig(max_batch=1, max_delay_ms=50.0,
                                    precision=None))
        await svc.start()
        outs = await asyncio.gather(svc.focus(raw, CFG),
                                    svc.focus(raw * 0.5, CFG),
                                    svc.focus(raw, CFG))
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert snap["batch_size_hist"] == {1: 3}, snap
    assert np.array_equal(outs[0], refs[0])
    assert np.array_equal(outs[1], refs[1])
    assert np.array_equal(outs[2], refs[0])


def test_inflight_cap_backpressure_coalesces_backlog_bit_identical():
    """One lane, one in-flight slot: while batch 1 runs, arrivals park
    behind the cap and coalesce into a FULL batch."""
    raw = scene()
    ref = reference()
    backend = _RecordingBackend(fast_backend(), delay=0.3)

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=5.0,
                                    precision=None, lanes=1,
                                    inflight_cap=1), backend)
        await svc.start(warm=[(CFG, "fused3", None)])
        t1 = asyncio.ensure_future(svc.focus(raw, CFG))
        await asyncio.sleep(0.15)       # batch 1 in flight on the lane
        rest = [asyncio.ensure_future(svc.focus(raw, CFG))
                for _ in range(4)]
        outs = await asyncio.gather(t1, *rest)
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert backend.max_active == 1          # the cap held
    assert snap["batch_size_hist"] == {1: 1, 4: 1}, snap
    for o in outs:
        assert np.array_equal(o, ref)


def test_continuous_batching_overlaps_batches_across_lanes():
    """Two different-key batches run CONCURRENTLY on two lanes, both
    images bit-identical to their per-request references."""
    raw = scene()
    ref3, refo = reference(), reference("omegak")
    backend = _RecordingBackend(fast_backend(), delay=0.3)

    async def main():
        svc = service(ServiceConfig(max_batch=2, max_delay_ms=20.0,
                                    precision=None, lanes=2,
                                    inflight_cap=2), backend)
        await svc.start()
        outs = await asyncio.gather(
            svc.focus(raw, CFG), svc.focus(raw, CFG),
            svc.focus(raw, CFG, variant="omegak"),
            svc.focus(raw, CFG, variant="omegak"))
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert backend.max_active == 2          # batches genuinely overlapped
    assert snap["batch_size_hist"] == {2: 2}, snap
    assert len(snap["lane_batches"]) == 2   # routed to distinct lanes
    assert np.array_equal(outs[0], ref3)
    assert np.array_equal(outs[1], ref3)
    assert np.array_equal(outs[2], refo)
    assert np.array_equal(outs[3], refo)


def test_past_deadline_request_dropped_with_request_cancelled():
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=400.0,
                                    precision=None))
        await svc.start()
        with pytest.raises(RequestCancelled, match="deadline_ms=50"):
            await svc.focus(raw, CFG, deadline_ms=50.0)
        await svc.stop()
        return svc.metrics.snapshot()

    snap = asyncio.run(main())
    assert snap["cancelled"] == 1
    assert snap["deadline_dropped"] == 1
    assert snap["deadline_miss_rate"] == 1.0
    assert snap["batch_size_hist"] == {}    # nothing reached a lane


def test_client_cancelled_request_dropped_before_dispatch():
    raw = scene()
    ref = reference()

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=200.0,
                                    precision=None))
        await svc.start()
        t_cancel = asyncio.ensure_future(svc.focus(raw * 0.5, CFG))
        t_keep = asyncio.ensure_future(svc.focus(raw, CFG))
        await asyncio.sleep(0.05)           # both bucketed, flush at 200ms
        t_cancel.cancel()
        out = await t_keep
        with pytest.raises(asyncio.CancelledError):
            await t_cancel
        await svc.stop()
        return out, svc.metrics.snapshot()

    out, snap = asyncio.run(main())
    assert snap["cancelled"] == 1
    assert snap["deadline_dropped"] == 0
    assert snap["batch_size_hist"] == {1: 1}    # cancelled never padded in
    assert np.array_equal(out, ref)


def test_overload_sheds_latest_deadline_pending_request():
    raw = scene()
    ref = reference()

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=400.0,
                                    precision=None, max_queue=1))
        await svc.start()
        victim = asyncio.ensure_future(svc.focus(raw * 0.5, CFG))
        await asyncio.sleep(0.05)           # victim bucketed: backlog = 1
        out = await svc.focus(raw, CFG, deadline_ms=5000.0)
        with pytest.raises(RequestCancelled, match="shed under overload"):
            await victim
        await svc.stop()
        return out, svc.metrics.snapshot()

    out, snap = asyncio.run(main())
    assert snap["shed"] == 1
    assert snap["rejected"] == 0
    assert np.array_equal(out, ref)


def test_worker_pool_routing_and_cost_weights():
    pool = WorkerPool(lanes=2, inflight_cap=2)
    k = BatchKey(CFG, "fused3", None, False)
    ks = BatchKey(CFG, "fused3", None, True)
    assert pool.route(ks) is pool.stream_lane
    assert pool.route(k) is pool.batch_lanes[0]     # tie -> lowest lane
    assert pool.predicted_seconds(k, batch=1) > 0
    assert (pool.predicted_seconds(k, batch=8)
            > pool.predicted_seconds(k, batch=1))
    big = BatchKey(make_test_scene(512), "fused3", None, False)
    assert pool.predicted_seconds(big) > pool.predicted_seconds(k)
    pool.batch_lanes[0].backlog_s = 10.0
    assert pool.route(k) is pool.batch_lanes[1]


# ---------------------------------------------------------------------------
# The precision SNR gate and the default tier
# ---------------------------------------------------------------------------

def test_snr_gate_rejects_out_of_gate_precision():
    raw = scene()

    async def main(deviation):
        svc = service(ServiceConfig(max_batch=1, snr_gate_db=0.1),
                      precision_deviation=lambda p: deviation)
        await svc.start()
        try:
            out = await svc.focus(raw, CFG, precision="bs16")
        finally:
            await svc.stop()
        return out, svc.metrics.snapshot()

    with pytest.raises(SnrGateViolation, match="0.1 dB gate"):
        asyncio.run(main(0.5))

    out, snap = asyncio.run(main(0.05))
    assert snap["gate_rejected"] == 0
    # the precision threads through to the compiled kernels
    assert not np.array_equal(out, reference())
    assert np.array_equal(out, reference(precision="bs16"))


def test_f32_requests_never_consult_the_gate():
    raw = scene()

    def boom(p):
        raise AssertionError("gate consulted for f32")

    async def main():
        svc = service(ServiceConfig(max_batch=1, precision=None),
                      precision_deviation=boom)
        await svc.start()
        a = await svc.focus(raw, CFG)
        b = await svc.focus(raw, CFG, precision="f32")
        await svc.stop()
        return a, b

    a, b = asyncio.run(main())
    ref = reference()
    assert np.array_equal(a, ref)
    assert np.array_equal(b, ref)


def test_default_serving_tier_is_bs16_behind_the_measured_gate():
    """Out of the box an un-annotated request resolves to bs16, behind
    the port's own measured gate (``tuning.quality`` on the service's
    device, 256^2 focused at bs16 and f32): within 0.1 dB here, so bs16
    serves — through the fused1 route, bit-equal to fused1 and fused3 at
    bs16 — and an explicit 'f32' request takes the verification path."""
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=1))
        await svc.start()
        tier = await svc.focus(raw, CFG)
        verify = await svc.focus(raw, CFG, precision="f32")
        await svc.stop()
        return tier, verify, svc

    tier, verify, svc = asyncio.run(main())
    assert 0.0 <= svc._gate_cache["bs16"] <= GATE_DB, svc._gate_cache
    assert svc.metrics.snapshot()["tier_fallbacks"] == 0
    assert np.array_equal(tier, reference("fused1", precision="bs16"))
    assert np.array_equal(tier, reference(precision="bs16"))
    assert np.array_equal(verify, reference())
    assert not np.array_equal(tier, verify)


def test_service_restarts_after_stop():
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=1, precision=None))
        await svc.start()
        a = await svc.focus(raw, CFG)
        await svc.stop()
        await svc.start()
        b = await svc.focus(raw, CFG)
        await svc.stop()
        return a, b

    a, b = asyncio.run(main())
    ref = reference()
    assert np.array_equal(a, ref)
    assert np.array_equal(b, ref)


def test_focus_rejected_when_service_not_running():
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=1, precision=None))
        with pytest.raises(RuntimeError, match="not running"):
            await svc.focus(raw, CFG)          # never started
        await svc.start()
        out = await svc.focus(raw, CFG)
        await svc.stop()
        with pytest.raises(RuntimeError, match="not running"):
            await svc.focus(raw, CFG)          # after stop
        return out

    assert np.array_equal(asyncio.run(main()), reference())


# ---------------------------------------------------------------------------
# Route invisibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bf16", "f16", "bs16"])
@pytest.mark.parametrize("fused1", ["auto", "off"])
def test_route_invisibility_matrix(fused1, precision):
    """Serving output is IDENTICAL whichever route the backend picks: the
    fused1 megakernel (the port's resident cut at 128^2) or the three
    per-axis launches, at every precision — bs16 included."""
    raw = scene()[None]
    backend = fast_backend(fused1=fused1)
    key = BatchKey(CFG, "fused3", precision, False)
    want_route = "fused1" if fused1 == "auto" else "fused3"
    assert backend._route_variant(key) == want_route
    out = backend.execute(key, raw)
    kw = {} if precision is None else {"precision": precision}
    np.testing.assert_array_equal(out[0], reference(**kw))


def test_route_follows_the_ports_residency_cut():
    """128^2 fits one block's shared memory (one ``mega_resident``
    launch); 256^2 does not, so it keeps fused3's three launches — the
    twin route never picks ``mega_staged``."""
    backend = fast_backend()
    assert ops.mega_residency(128, 128) == "vmem"
    assert backend._route_variant(BatchKey(CFG, "fused3", "bs16", False)) \
        == "fused1"
    big = make_test_scene(256)
    assert backend._route_variant(BatchKey(big, "fused3", "bs16", False)) \
        == "fused3"
    assert backend._route_variant(BatchKey(CFG, "fused", None, False)) \
        == "fused"


# ---------------------------------------------------------------------------
# Streaming route
# ---------------------------------------------------------------------------

def test_over_budget_scene_takes_streaming_route():
    raw = scene()
    ref = reference()
    backend = fast_backend()
    assert backend._sharded_twin(BatchKey(CFG, "fused3", None, True)) \
        is None, "the sharded route is not ported: strips serve"

    async def main():
        svc = service(ServiceConfig(max_batch=4, max_delay_ms=200.0,
                                    precision=None,
                                    device_budget_bytes=raw.nbytes - 1),
                      backend)
        await svc.start()
        outs = await asyncio.gather(svc.focus(raw, CFG),
                                    svc.focus(raw, CFG))
        await svc.stop()
        return outs, svc.metrics.snapshot()

    outs, snap = asyncio.run(main())
    assert snap["streamed"] == 2            # never coalesced
    assert snap["lane_batches"] == {"stream": 2}
    assert not backend.fallbacks
    for o in outs:
        assert np.array_equal(o, ref)       # streamed == in-memory


# ---------------------------------------------------------------------------
# Metrics artifact
# ---------------------------------------------------------------------------

def test_service_metrics_emit_valid_schema2_bench_doc(tmp_path):
    raw = scene()

    async def main():
        svc = service(ServiceConfig(max_batch=2, max_delay_ms=100.0,
                                    precision=None))
        await svc.start()
        await asyncio.gather(svc.focus(raw, CFG), svc.focus(raw, CFG))
        await svc.stop()
        return svc

    svc = asyncio.run(main())
    doc = svc.metrics.to_bench_doc(section="service_test")
    validate_bench_doc(doc)                 # schema 2, ISO-8601 stamp
    assert doc["backend"] == "cpu" and doc["jax_version"] is None
    assert doc["torch_version"] == torch.__version__
    assert "cuda_version" in doc and "nvidia_smi" not in doc
    path = tmp_path / "BENCH_service_test.json"
    svc.metrics.write_bench_json(str(path))
    validate_bench_file(str(path))
    snap = svc.metrics.snapshot()
    assert snap["completed"] == 2
    assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] > 0
    assert snap["batch_fill_hist"] == {"2/2": 1}
    assert sum(snap["lane_batches"].values()) == 1
    assert set(snap["lane_occupancy"]) == {"fused0", "fused1", "stream"}
    rows = {r["name"]: r for r in doc["rows"]}
    assert "lanes=3" in rows["lanes"]["derived"]
    assert "occ_fused0=" in rows["lanes"]["derived"]
    assert "fill_hist=" in rows["batching"]["derived"]
    assert "goodput_rps=" in rows["throughput"]["derived"]
    assert "deadline_miss_rate=" in rows["throughput"]["derived"]


# ---------------------------------------------------------------------------
# Against the JAX package's service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bs16"])
def test_port_service_image_within_gate_of_the_jax_service(precision):
    """The same numpy scene through both packages' services (default
    variant, fused1 route at 128^2): the same peaks, |dSNR| <= 0.1 dB."""
    jcfg = make_jscene(128)
    targets = jtargets(jcfg)
    raw = np.asarray(jsimulate_cached(jcfg, targets), np.complex64)
    cfg = scene_from_dict(dataclasses.asdict(jcfg))

    async def serve(svc, scene_cfg):
        await svc.start()
        out = await svc.focus(raw, scene_cfg, precision=precision)
        await svc.stop()
        return out

    config = dict(max_batch=1, precision=None)
    ours = asyncio.run(serve(service(ServiceConfig(**config),
                                     precision_deviation=lambda p: 0.0),
                             cfg))
    theirs = asyncio.run(serve(JFocusService(
        JServiceConfig(**config), backend=JLocalBackend(
            sweep=((None, None),)),
        precision_deviation=lambda p: 0.0), jcfg))
    a = jmetrics.analyze_scene(ours, jcfg, targets)
    b = jmetrics.analyze_scene(np.asarray(theirs), jcfg, targets)
    assert [(r.row, r.col) for r in a] == [(r.row, r.col) for r in b]
    c = jmetrics.compare_pipelines(ours, np.asarray(theirs), jcfg, targets)
    assert max(c["snr_delta_db"]) <= GATE_DB, c["snr_delta_db"]
