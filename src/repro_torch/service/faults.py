"""Seam-level fault injection for the serving stack.

Chaos engineering needs faults at the seams the real fleet breaks at,
not `raise` statements sprinkled into product code. This module wraps
any serving backend (`ChaosBackend`) and injects failures from a SEEDED,
deterministic schedule at the exact seams `service._run_batch` has to
survive:

``dispatch_error``  the backend raises mid-dispatch (OOM, runtime error)
``nan_output``      the dispatch "succeeds" but scene 0 of the returned
                    batch is silently corrupted with NaNs — exercising
                    the output health sentinel, not the except path
``lane_hang``       the lane thread blocks (dead device queue) until the
                    stall watchdog restarts the lane; the injector keeps
                    a release hook so tests/benches never leak a hung
                    thread past process exit
``straggler``       the dispatch completes but ``delay_s`` late
``cache_corrupt``   the tuning cache file is truncated mid-flight,
                    exercising the quarantine-and-rebuild path
``poison_scene``    any batch containing a registered scene (matched by
                    content digest) fails deterministically EVERY time —
                    the bisection seam: retries don't help, only
                    splitting the batch isolates the poison

It unifies `repro_torch.distributed.fault` — `SimulatedFailure` is the one
injected-error type across the distributed layer and the service, the
step-keyed `FailureInjector` drives dispatch-ordinal placement, and the
`StragglerWatchdog` is re-exported for lane-level slow-dispatch
flagging — rather than growing a second fault toolkit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.fault import (       # noqa: F401  (re-exports)
    FailureInjector,
    SimulatedFailure,
    StragglerWatchdog,
)

SEAMS = ("dispatch_error", "nan_output", "lane_hang", "straggler",
         "cache_corrupt", "poison_scene")

_LANE_THREAD_RE = re.compile(r"^lane-([^_]+)_\d+$")


def current_lane() -> Optional[str]:
    """The worker-pool lane name this thread belongs to (None off-lane).
    Lane executors name their threads ``lane-<name>_<i>``."""
    m = _LANE_THREAD_RE.match(threading.current_thread().name)
    return m.group(1) if m else None


def scene_digest(raw: np.ndarray) -> str:
    """Content digest of one host scene — how poison faults identify
    their target across batching, padding, and bisection."""
    arr = np.ascontiguousarray(np.asarray(raw))
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    seam          one of SEAMS.
    at_dispatch   the 0-based dispatch ordinal the fault fires at
                  (counted across execute + execute_streamed calls;
                  None for content-keyed poison_scene faults).
    lane          restrict to dispatches running on this lane (None =
                  any lane); a fault whose ordinal arrives on another
                  lane simply fires there — the ordinal, not the lane,
                  is the primary key.
    delay_s       straggler delay.
    match         scene_digest() of the poisoned scene.
    """

    seam: str
    at_dispatch: Optional[int] = None
    lane: Optional[str] = None
    delay_s: float = 0.0
    match: Optional[str] = None

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}; known: {SEAMS}")
        if self.seam == "poison_scene":
            if self.match is None:
                raise ValueError("poison_scene needs a scene digest")
        elif self.at_dispatch is None:
            raise ValueError(f"{self.seam} needs at_dispatch")


def seeded_schedule(seed: int, n_dispatches: int,
                    seams: Sequence[str] = ("dispatch_error", "nan_output",
                                            "lane_hang"),
                    first: int = 2, delay_s: float = 0.25,
                    ) -> List[FaultSpec]:
    """Deterministic fault schedule: one fault per requested seam,
    placed at distinct dispatch ordinals in ``[first, n_dispatches)``
    drawn from a seeded PRNG (the chaos-replay harness's schedule —
    same seed, same faults). ``first`` keeps the earliest dispatches
    clean so lane service-time EWMAs warm before the first stall."""
    ordinals = list(range(first, max(n_dispatches, first + len(seams))))
    rng = random.Random(seed)
    rng.shuffle(ordinals)
    specs = []
    for seam, at in zip(seams, sorted(ordinals[:len(seams)])):
        specs.append(FaultSpec(seam=seam, at_dispatch=at,
                               delay_s=delay_s if seam == "straggler"
                               else 0.0))
    return specs


class FaultInjector:
    """Replays a fault schedule keyed by dispatch ordinal.

    Thread-safe: lane threads call ``begin``/``finish`` around each
    backend dispatch. Each ordinal-keyed fault fires once (the
    underlying `distributed.fault.FailureInjector` semantics); poison
    faults fire on EVERY dispatch whose batch contains the poisoned
    scene, which is what makes bisection — not retry — the only cure.
    """

    def __init__(self, faults: Sequence[FaultSpec] = (),
                 hang_timeout_s: float = 120.0,
                 on_cache_corrupt: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._dispatch = 0
        self._by_ordinal: Dict[int, FaultSpec] = {}
        self._poison: Dict[str, FaultSpec] = {}
        for spec in faults:
            if spec.seam == "poison_scene":
                self._poison[spec.match] = spec
            else:
                if spec.at_dispatch in self._by_ordinal:
                    raise ValueError(
                        f"two faults at dispatch {spec.at_dispatch}")
                self._by_ordinal[spec.at_dispatch] = spec
        # ordinal-keyed faults fire once each — delegated to the
        # distributed layer's step-keyed injector for the bookkeeping
        self._armed = FailureInjector(tuple(self._by_ordinal))
        self.hang_timeout_s = hang_timeout_s
        self.on_cache_corrupt = on_cache_corrupt
        self.fired: List[Tuple[int, FaultSpec]] = []
        self._hangs: List[threading.Event] = []

    # -- lifecycle -----------------------------------------------------------
    def release_hangs(self) -> None:
        """Unblock every injected hang immediately. Tests and benches
        MUST call this in teardown: lane restarts abandon the hung
        thread, but ThreadPoolExecutor joins all threads at interpreter
        exit, so an un-released hang would stall process shutdown until
        ``hang_timeout_s``."""
        with self._lock:
            hangs = list(self._hangs)
        for ev in hangs:
            ev.set()

    @property
    def faults_fired(self) -> int:
        return len(self.fired)

    def seams_fired(self) -> List[str]:
        return sorted({spec.seam for _, spec in self.fired})

    # -- injection seams -----------------------------------------------------
    def _take(self, scenes: Sequence[np.ndarray]
              ) -> Tuple[int, Optional[FaultSpec]]:
        with self._lock:
            ordinal = self._dispatch
            self._dispatch += 1
            # ordinal-keyed faults are consulted FIRST: a poison hit at
            # the same dispatch must not shadow (and silently swallow) a
            # one-shot fault scheduled there — the poison re-fires on
            # the scene's next dispatch anyway, the ordinal never
            # comes back
            spec = self._by_ordinal.get(ordinal)
            if spec is not None and spec.lane in (None, current_lane()):
                try:
                    self._armed.check(ordinal)     # fires once per ordinal
                except SimulatedFailure:
                    self.fired.append((ordinal, spec))
                    return ordinal, spec
            for raw in scenes:
                pspec = self._poison.get(scene_digest(raw))
                if pspec is not None:
                    self.fired.append((ordinal, pspec))
                    return ordinal, pspec
            return ordinal, None

    def begin(self, scenes: Sequence[np.ndarray]) -> Tuple[int,
                                                           Optional[FaultSpec]]:
        """Called on the lane thread before the inner dispatch. Raises,
        sleeps, or hangs according to the schedule; returns the ordinal
        and any pending output-corruption fault for ``finish``."""
        ordinal, spec = self._take(scenes)
        if spec is None:
            return ordinal, None
        if spec.seam == "poison_scene":
            raise SimulatedFailure(
                f"injected poison scene (digest {spec.match}) at "
                f"dispatch {ordinal}")
        if spec.seam == "dispatch_error":
            raise SimulatedFailure(
                f"injected dispatch error at dispatch {ordinal}")
        if spec.seam == "lane_hang":
            ev = threading.Event()
            with self._lock:
                self._hangs.append(ev)
            ev.wait(self.hang_timeout_s)
            # by now the stall watchdog has restarted the lane and
            # retried elsewhere; fail the abandoned call for hygiene
            raise SimulatedFailure(
                f"injected lane death at dispatch {ordinal} "
                f"(lane {current_lane()})")
        if spec.seam == "straggler":
            ev = threading.Event()       # interruptible sleep (release_hangs)
            with self._lock:
                self._hangs.append(ev)
            ev.wait(spec.delay_s)
            return ordinal, None
        if spec.seam == "cache_corrupt":
            if self.on_cache_corrupt is not None:
                self.on_cache_corrupt()
            return ordinal, None
        return ordinal, spec                       # nan_output: apply after

    def finish(self, pending: Optional[FaultSpec],
               images: np.ndarray) -> np.ndarray:
        """Apply a pending output-corruption fault to the completed
        dispatch's images (scene 0 only — its coalesced neighbors stay
        healthy, so the sentinel isolates exactly one request)."""
        if pending is None or pending.seam != "nan_output":
            return images
        out = np.array(images, copy=True)
        flat = out.reshape(out.shape[0], -1) if out.ndim > 1 \
            else out.reshape(1, -1)
        flat[0, :min(8, flat.shape[1])] = np.nan
        return out


def truncate_file(path: str, keep: int = 17) -> None:
    """Corrupt a file in place by truncating it mid-token (the
    cache_corrupt seam's default action)."""
    try:
        with open(path, "r+b") as f:
            f.truncate(keep)
    except OSError:
        pass                           # file absent: nothing to corrupt


class ChaosBackend:
    """Backend wrapper that replays a FaultInjector schedule around the
    inner backend's dispatches. `warm()` passes through un-faulted (the
    schedule counts SERVING dispatches), so warm-up stays deterministic
    and the ordinal clock starts at the first real request."""

    name = "chaos"

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def warm(self, key, max_batch: int = 4) -> None:
        self.inner.warm(key, max_batch)

    def execute(self, key, batch: np.ndarray) -> np.ndarray:
        _, pending = self.injector.begin(list(batch))
        out = self.inner.execute(key, batch)
        return self.injector.finish(pending, out)

    def execute_streamed(self, key, raw: np.ndarray,
                         strips: int = 4) -> np.ndarray:
        _, pending = self.injector.begin([raw])
        out = self.inner.execute_streamed(key, raw, strips)
        return self.injector.finish(pending, out[None])[0]
