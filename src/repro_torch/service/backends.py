"""Pluggable execution backends for the focusing service.

A backend turns one coalesced micro-batch into focused images, blocking
the calling thread (the service invokes it on a worker-pool lane thread
so the event loop keeps admitting requests while the card computes). One
is ported:

``local``    One-device execution through the warm compiled-pipeline
             cache (`core.plan.cached_pipeline`): per BatchKey, ONE
             Pipeline whose filter payloads and tuned configs persist
             across requests. Scenes whose whole slab fits one block's
             shared memory (``ops.mega_residency`` says 'vmem': 128^2,
             2 x 8192, 1 x 16384, at any split) are transparently routed
             from their per-axis variant to its single-launch megakernel
             twin (FUSED1_TWINS; bit-identical at every precision,
             `fused1="off"` opts out), so a 128^2 or 2 x 8192 default
             request is one ``mega_resident`` launch and a 4096^2 one is
             fused3's three spectral launches. `warm()`
             optionally sweeps a few (block, col_block) line-block
             configs on the real batched pipeline, each timed between two
             device synchronisations, and pins the winner; the sweep runs
             through `repro_torch.tuning.measured_search` and persists to
             the device-fingerprinted tuning cache under a pipeline-kind
             TuneKey, so the next process's `warm()` is a cache hit. On a
             CUDA card each lane thread runs its batches on a CUDA stream
             of its own: the batch goes up from pinned host memory, and
             `execute` returns once the images are back on the host.
             Big streamed scenes route to the SHARDED megakernel twin
             when the mesh has more than one device and the cost model
             prefers it (`sharded="off"` opts out; see
             `execute_streamed`).

``sharded``  Multi-device execution through the corner-turn lowering
             (`core.sar.distributed.build_sharded`) over a single-process
             device mesh: schedule 'corner2' lowers the compiled plan
             generically (an all-to-all at each transform-axis change),
             'halo' runs the hand-written single-turn RDA schedule.
             Oversized scenes go through the mesh too — P devices hold P
             times the budget — so this backend has no separate
             streaming path.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tuning
from repro_torch._device import resolve_device
from repro_torch.core import plan as planlib
from repro_torch.kernels.fft4step import resolve_precision
from repro_torch.service.queue import BatchKey
from repro_torch.service.resilience import BreakerBoard


def _resolve_blocks(cfg, block: Optional[int], col_block: Optional[int]):
    """-1 means 'all lines' for the respective launch orientation."""
    if block == -1:
        block = cfg.na
    if col_block == -1:
        col_block = cfg.nr
    return block, col_block


# Batch-size buckets are powers of two: a partial batch pads with zero
# scenes up to the next warmed bucket, so every shape a lane runs is one
# warm() ran before. Zero scenes are numerically inert (every stage maps
# 0 -> 0) and their rows are sliced off the reply. The SAME buckets key
# the tuning cache (tuning.TuneKey normalizes batch through this), so a
# padded batch always looks up the config tuned for the shape that runs.
_bucket = tuning.bucket_batch

# Per-axis variants with a single-launch megakernel twin: when the
# scene's whole slab fits one block (repro_torch.tuning.cost.mega_residency
# says 'vmem': 16384 points, lines past 4096 points and three-factor splits
# included, as the reference's cut), the local backend transparently
# serves these through the fused1 pipeline — the same math bit for bit at
# EVERY precision (bs16
# carries per-line block exponents through the in-kernel corner turns,
# so the one launch quantizes exactly like the per-axis chain), one
# launch and no device-memory intermediates instead of three round trips.
FUSED1_TWINS = {
    "fused3": "fused1",
    "csa_fused": "csa_fused1",
    "omegak": "omegak_fused1",
}

def _pad_batch(batch: np.ndarray) -> np.ndarray:
    b = batch.shape[0]
    pb = _bucket(b)
    if pb == b:
        return batch
    pad = np.zeros((pb - b, *batch.shape[1:]), batch.dtype)
    return np.concatenate([batch, pad])


class LocalBackend:
    """Single-device backend over the compiled-pipeline cache.

    ``device=None`` is the CUDA card (raises without one); ``"cpu"`` runs
    the kernels' plain versions. ``mesh`` is the device mesh the sharded
    route of ``execute_streamed`` runs on: None is every visible card
    (``distributed.make_sar_mesh``, built at first use, so a backend on
    one card never shards), and an explicit mesh stands where the
    reference sets ``XLA_FLAGS`` to emulate devices — e.g.
    ``make_sar_mesh(devices=[torch.device("cpu")] * 8)``."""

    name = "local"

    def __init__(self, device=None,
                 sweep: Sequence[Tuple[Optional[int], Optional[int]]]
                 = ((None, None), (32, -1)), tune_cache=None,
                 fused1: str = "auto", sharded: str = "auto", mesh=None,
                 breakers: Optional[BreakerBoard] = None):
        if fused1 not in ("auto", "off"):
            raise ValueError(f"fused1 must be 'auto' or 'off', got "
                             f"{fused1!r}")
        if sharded not in ("auto", "off"):
            raise ValueError(f"sharded must be 'auto' or 'off', got "
                             f"{sharded!r}")
        self.device = resolve_device(device)
        self.sweep = tuple(sweep)
        self.fused1 = fused1
        self.sharded = sharded
        self._mesh = mesh
        # per-route circuit breakers (route x variant x shape x precision):
        # a route that keeps failing is skipped on the hot path until its
        # cooldown expires, then re-probed half-open
        self.breakers = breakers if breakers is not None else BreakerBoard()
        self.fallbacks: Counter = Counter()  # degraded-route serve counts
        self._tune_cache = tune_cache       # None -> the shared default
        self._best: Dict[BatchKey, Tuple[Optional[int], Optional[int]]] = {}
        self._sched: Dict[BatchKey, "tuning.Schedule"] = {}
        self._fns: Dict[Tuple[BatchKey, str], callable] = {}
        self._sharded_fns: Dict[BatchKey, callable] = {}
        self._lane = threading.local()      # each thread's CUDA stream

    # -- the card ------------------------------------------------------------
    def _stream(self) -> Optional[torch.cuda.Stream]:
        """The calling thread's own CUDA stream (None on the CPU): each
        lane thread runs its batches on a stream of its own, so one lane's
        copies overlap another lane's kernels."""
        if self.device.type != "cuda":
            return None
        stream = getattr(self._lane, "stream", None)
        if stream is None:
            stream = self._lane.stream = torch.cuda.Stream(self.device)
        return stream

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """A host batch on the pipeline's device: on the card, through
        pinned memory with a non-blocking copy on the current stream."""
        t = torch.from_numpy(np.ascontiguousarray(host, np.complex64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, images: torch.Tensor) -> np.ndarray:
        """Images back on the host, complete: on the card, copied into
        pinned memory on the current stream, which is then synchronised."""
        if self.device.type != "cuda":
            return images.numpy()
        out = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        out.copy_(images, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- routing -------------------------------------------------------------
    def _route_variant(self, key: BatchKey) -> str:
        """The variant actually compiled for a BatchKey: scenes whose slab
        fits one block requesting a per-axis variant with a megakernel
        twin are served by the single-launch fused1 pipeline
        (`fused1="off"` pins the requested variant). The route must be
        invisible — the served image equals the requested variant's bit
        for bit — and it is, at every precision (the route-invisibility
        matrix in tests/test_torch_service.py)."""
        twin = FUSED1_TWINS.get(key.variant)
        if (self.fused1 == "auto" and twin is not None
                and tuning.cost.mega_residency(key.scene.na, key.scene.nr)
                == "vmem"):
            return twin
        return key.variant

    def _pipeline(self, key: BatchKey, batch: int = 1,
                  variant: Optional[str] = None):
        """The compiled pipeline serving ``key`` — at the routed tier-0
        variant by default, or at an explicit ``variant`` (a degraded
        tier, or the requested per-axis variant for sweeps/streams)."""
        block, col_block = _resolve_blocks(
            key.scene, *self._best.get(key, (None, None)))
        kw = dict(batch=batch, device=self.device)
        if key.precision is not None:
            kw["precision"] = key.precision
        if block is not None:
            kw["block"] = block
        if col_block is not None:
            kw["col_block"] = col_block
        sched = self._sched.get(key)
        if sched is not None:
            kw["schedule"] = sched
        if variant is None:
            variant = self._route_variant(key)
        return planlib.cached_pipeline(key.scene, variant, **kw)

    def _fn(self, key: BatchKey, variant: Optional[str] = None):
        if variant is None:
            variant = self._route_variant(key)
        if (key, variant) not in self._fns:
            self._fns[(key, variant)] = \
                self._pipeline(key, variant=variant).jitted()
        return self._fns[(key, variant)]

    # -- tiered degradation --------------------------------------------------
    def _execute_tiers(self, key: BatchKey) -> List[Tuple[str, str]]:
        """Ordered (route_name, variant) tiers for a coalesced batch:
        the megakernel twin (when routed), then the requested per-axis
        variant. Both tiers launch the hand-written kernels and give the
        same image bit for bit; no tier falls back to a plain PyTorch
        chain. Tier 0 is EXACTLY what `_route_variant` serves on the
        fault-free path, so degradation never changes healthy results."""
        routed = self._route_variant(key)
        tiers = [("fused1" if routed != key.variant else "plan", routed)]
        if routed != key.variant:
            tiers.append(("plan", key.variant))
        return tiers

    def _breaker(self, route: str, variant: str, key: BatchKey):
        cfg = key.scene
        return self.breakers.get(
            f"{route}:{variant}:{cfg.na}x{cfg.nr}:{key.precision}")

    def _tune_key(self, key: BatchKey, max_batch: int) -> "tuning.TuneKey":
        cfg = key.scene
        return tuning.TuneKey.pipeline(
            variant=key.variant, na=cfg.na, nr=cfg.nr, batch=max_batch,
            precision=key.precision, backend=self.device.type)

    def warm(self, key: BatchKey, max_batch: int = 4) -> None:
        """Pre-pull everything a request would otherwise pay for: compile
        the plan (filters on the device, tuned kernel configs), resolve
        the (block, col_block) pipeline config — from the tuning cache
        when a previous process already swept this key, else by running
        the sweep through `repro_torch.tuning.measured_search` on a
        B=max_batch batch of zero scenes and persisting the winner — and
        run every power-of-two batch bucket up to max_batch once (partial
        batches pad to a bucket at execute time). Each sweep timing sits
        between two device synchronisations, so it times the card's work
        and not the host's enqueue."""
        cfg = key.scene
        with torch.cuda.stream(self._stream()):
            zeros = torch.zeros((_bucket(max_batch), cfg.na, cfg.nr),
                                dtype=torch.complex64, device=self.device)
            if len(self.sweep) > 1 and key not in self._best:
                self._sweep(key, max_batch, zeros)
            f = self._fn(key)
            b = 1
            while b <= zeros.shape[0]:
                f(zeros[:b])
                b *= 2
            self._sync()

    def _sweep(self, key: BatchKey, max_batch: int, zeros) -> None:
        tune_cache = self._tune_cache or tuning.get_cache()
        tkey = self._tune_key(key, max_batch)
        try:
            hit = tune_cache.get(tkey)
            sched = tune_cache.get_schedule(tkey)
        except Exception:
            hit = sched = None
                          # corrupt/foreign-schema file: fall back to
                          # the in-process sweep, never fail warm-up
        if hit is not None:
            self._best[key] = (hit.block, hit.col_block)
            # a persisted graph-search Schedule carries per-segment
            # decisions the flat config can't express — compile the
            # served pipeline through it; a degenerate (flat-derived)
            # schedule adds nothing, so skip it
            if sched is not None and \
                    sched != tuning.Schedule.from_config(hit):
                self._sched[key] = sched
            return

        def measure(cand, iters):
            self._best[key] = cand
            # sweep the REQUESTED per-axis pipeline: a mega-routed
            # pipeline ignores (block, col_block), so timing it would
            # persist a noise winner to the cache — the swept config is
            # what execute_streamed and fused1="off" actually consume
            f = self._pipeline(key, batch=max_batch,
                               variant=key.variant).jitted()
            f(zeros)                  # first launches: build and load
            self._sync()
            t0 = time.perf_counter()
            f(zeros)
            self._sync()
            return time.perf_counter() - t0

        best, seconds, _ = tuning.measured_search(
            self.sweep, measure, rungs=(1,))
        self._best[key] = best
        try:
            tune_cache.put(
                tkey, tuning.KernelConfig(block=best[0], col_block=best[1]),
                seconds=seconds, source="sweep")
        except Exception:
            pass      # read-only cache dir: the sweep result still
                      # serves this process, it just won't persist

    def execute(self, key: BatchKey, batch: np.ndarray) -> np.ndarray:
        """(B, na, nr) host batch -> (B, na, nr) focused images on the
        host. Pads to the nearest power-of-two bucket (see `_bucket`).

        Walks the degradation tiers (`_execute_tiers`): a tier whose
        circuit breaker is open is skipped (until its cooldown admits a
        half-open probe), a tier that raises — a kernel that does not
        build or launch included — records the failure and falls through
        to the next, and the LAST tier always runs so a request is never
        failed by an open breaker alone. When every tier raises, the last
        error is raised to the caller. On the fault-free path tier 0
        serves."""
        b = batch.shape[0]
        with torch.cuda.stream(self._stream()):
            padded = self._to_device(_pad_batch(batch))
            tiers = self._execute_tiers(key)
            last_err: Optional[Exception] = None
            for i, (route, variant) in enumerate(tiers):
                br = self._breaker(route, variant, key)
                if i < len(tiers) - 1 and not br.allow():
                    self.fallbacks[f"skip:{route}"] += 1
                    continue
                try:
                    out = self._to_host(self._fn(key, variant)(padded))
                except Exception as e:      # noqa: BLE001 — tier boundary
                    br.record_failure()
                    last_err = e
                    continue
                br.record_success()
                if (route, variant) != tiers[0]:
                    self.fallbacks[f"serve:{route}"] += 1
                return out[:b]
        raise last_err

    def _mesh_size(self) -> int:
        """Devices of the sharded route's mesh: the explicit mesh's, else
        the visible cards (0 where there is none)."""
        if self._mesh is not None:
            return self._mesh.size()
        if self.device.type != "cuda":
            return 0
        return torch.cuda.device_count()

    def mesh(self):
        """The sharded route's mesh (every visible card unless one was
        given), built at first use."""
        if self._mesh is None:
            from repro_torch.core.sar.distributed import make_sar_mesh
            self._mesh = make_sar_mesh()
        return self._mesh

    def _sharded_twin(self, key: BatchKey) -> Optional[str]:
        """The megakernel twin to run SHARDED for a big streamed scene, or
        None to keep the host-strip path. Routes when a twin exists (any
        precision: bs16's carried exponents are all-gathered across the
        corner turns, so the sharded image stays bit-identical), the mesh
        has more than one device, the scene tiles it, and the cost model
        prefers P per-device megakernels plus collective corner turns
        over strip-streaming one device
        (`repro_torch.tuning.cost.sharded_preferred`)."""
        twin = FUSED1_TWINS.get(key.variant)
        if self.sharded != "auto" or self.fused1 == "off" or twin is None:
            return None
        p = self._mesh_size()
        if p <= 1:
            return None
        cfg = key.scene
        prec = resolve_precision(key.precision).name
        if not tuning.cost.sharded_preferred(cfg.na, cfg.nr, devices=p,
                                             precision=prec):
            return None
        return twin

    def _sharded_fn(self, key: BatchKey):
        if key not in self._sharded_fns:
            mesh = self.mesh()
            kw = dict(device=mesh.device_list()[0])
            if key.precision is not None:
                kw["precision"] = key.precision
            pipe = planlib.cached_pipeline(
                key.scene, self._sharded_twin(key), **kw)
            self._sharded_fns[key] = pipe.lower_sharded(mesh)
        return self._sharded_fns[key]

    def execute_streamed(self, key: BatchKey, raw: np.ndarray,
                         strips: int = 4) -> np.ndarray:
        """One host-resident scene, over the single-device budget.

        Default path: Pipeline.run_streamed on the REQUESTED per-axis
        variant (strip copies overlapped with the launches; bit-identical
        to `execute`) — the streaming executor strips one free axis at a
        time, which a cross-axis megakernel step refuses.

        Multi-device path: when the cost model prefers it
        (`_sharded_twin`), the scene runs as the variant's megakernel
        twin lowered onto the mesh — one megakernel launch per device per
        phase group, all-to-all corner turns between groups, each device
        holding a 1/P slab. Every precision is bit-identical to the strip
        path (bs16's carried exponents ride the collectives), so the
        route stays invisible.

        Degradation: a failing (or breaker-open) sharded route falls back
        to the single-device strip path, counted in
        ``fallbacks["serve:local_stream"]``; both routes launch the
        hand-written kernels and give the same image bit for bit."""
        with torch.cuda.stream(self._stream()):
            twin = self._sharded_twin(key)
            if twin is not None:
                br = self._breaker("sharded", twin, key)
                if br.allow():
                    try:
                        out = self._sharded_fn(key)(
                            torch.from_numpy(np.ascontiguousarray(
                                raw, np.complex64)))
                        out = out.cpu().numpy()
                    except Exception:       # noqa: BLE001 — tier boundary
                        br.record_failure()
                        self.fallbacks["serve:local_stream"] += 1
                    else:
                        br.record_success()
                        return out
                else:
                    self.fallbacks["skip:sharded"] += 1
            return self._pipeline(key, variant=key.variant).run_streamed(
                raw, strips=strips)


class ShardedBackend:
    """Multi-device backend over the corner-turn lowering.

    ``mesh=None`` is ``distributed.make_sar_mesh(axes)`` over every
    visible card, or over ``device`` alone where one is named (a
    one-device mesh: ``device="cpu"`` runs the plain versions). An
    explicit mesh stands where the reference sets ``XLA_FLAGS`` to
    emulate devices, e.g. ``make_sar_mesh(devices=[cuda:0] * 8)`` for
    eight slabs on one card."""

    name = "sharded"

    def __init__(self, mesh=None, axes=("data",), schedule: str = "corner2",
                 turn_dtype=None, device=None):
        from repro_torch.core.sar.distributed import make_sar_mesh
        if mesh is None:
            mesh = make_sar_mesh(
                axes, None if device is None else [resolve_device(device)])
        self.mesh = mesh
        self.axes = axes
        self.schedule = schedule
        self.turn_dtype = turn_dtype
        self.device = mesh.device_list(axes)[0]
        self._fns: Dict[BatchKey, callable] = {}

    def _fn(self, key: BatchKey):
        if key not in self._fns:
            from repro_torch.core.sar.distributed import build_sharded
            kw = {}
            if key.precision is not None:
                kw["precision"] = key.precision
            self._fns[key] = build_sharded(
                key.scene, key.variant, self.mesh, self.axes,
                schedule=self.schedule, turn_dtype=self.turn_dtype, **kw)
        return self._fns[key]

    def _run(self, key: BatchKey, x) -> np.ndarray:
        return self._fn(key)(
            torch.from_numpy(np.ascontiguousarray(x, np.complex64))
        ).cpu().numpy()

    def warm(self, key: BatchKey, max_batch: int = 4) -> None:
        """Compile the lowering and run it once per power-of-two batch
        bucket up to ``max_batch`` (the halo runner once, per scene)."""
        cfg = key.scene
        if self.schedule == "halo":
            self._run(key, np.zeros((cfg.na, cfg.nr), np.complex64))
            return
        zeros = np.zeros((_bucket(max_batch), cfg.na, cfg.nr), np.complex64)
        b = 1
        while b <= zeros.shape[0]:
            self._run(key, zeros[:b])
            b *= 2

    def execute(self, key: BatchKey, batch: np.ndarray) -> np.ndarray:
        """(B, na, nr) host batch -> (B, na, nr) focused images on the
        host, padded to its power-of-two bucket like the local backend's
        (the halo schedule runs scene by scene)."""
        if self.schedule == "halo":
            return np.stack([self._run(key, x) for x in batch])
        b = batch.shape[0]
        return self._run(key, _pad_batch(batch))[:b]

    def execute_streamed(self, key: BatchKey, raw: np.ndarray,
                         strips: int = 4) -> np.ndarray:
        # a scene over the single-device budget fits the mesh: the slabs
        # are 1/P of the scene each, so it just runs sharded
        return self._run(key, raw)


BACKENDS = {"local": LocalBackend, "sharded": ShardedBackend}


def make_backend(name: str, **kw):
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; known: {sorted(BACKENDS)}")
    return BACKENDS[name](**kw)
