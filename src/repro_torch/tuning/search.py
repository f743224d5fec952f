"""Cost-model-guided measured search with successive-halving early stopping
(the port's copy of the JAX package's ``repro.tuning.search``: the same
engine, frontier solver and entry points, timing the CUDA kernels).

Replaces the exhaustive ``itertools.product`` sweep of the old
benchmarks/autotune.py: candidates are feasibility-cut and RANKED by the
analytic roofline model (cost.py) first, only the top of the ranking is
ever timed, and the timed set shrinks by half per rung while the per-rung
measurement budget grows — so the search reaches the same winner as the
exhaustive sweep while timing strictly fewer candidates ("Shortest-Path
FFT", arXiv 2604.04311: guided beats enumeration).

Three entry points:

* :func:`measured_search` — the generic engine: any candidate list, any
  measure callable. The serving warm sweep (service/backends.py) runs its
  (block, col_block) pipeline candidates through this in the reference.
* :func:`search_kernel` — the kernel tuner: builds the schedule graph
  for a :class:`TuneKey`, solves it for the ranked frontier
  (:func:`schedule_frontier`), applies the SNR gate (non-f32 precisions
  must pass ``repro_torch.tuning.quality`` at <= ``snr_gate_db``), times
  the fused fwd+inv rows launch, and persists the winner to the shared
  cache.
* :func:`search_schedule` — the megakernel schedule tuner: solves a
  multi-segment :class:`~repro_torch.tuning.space.ScheduleProblem` (where
  per-segment factorizations make the space exponential in the segment
  count — exactly where shortest-path enumeration beats the product
  sweep), measures the top of the frontier, persists the winning
  Schedule.

Plus the cache-only lookups the plan compiler uses at compile time
(:func:`cached_config` / :func:`cached_schedule`, never sweep) and
:func:`best_config` (cached-or-tuned, the CLI/bench entry).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.tuning import cache as cachelib
from repro_torch.tuning import cost as costlib
from repro_torch.tuning.space import (
    KernelConfig,
    Schedule,
    ScheduleProblem,
    SegmentConfig,
    TuneKey,
    candidates,
    default_backend,
    device_fingerprint,
    factorizations,
)

DEFAULT_SNR_GATE_DB = 0.1

# Timing-jitter floor: every measured rung times a candidate at least
# this many times and takes the median, regardless of how few iterations
# the rung schedule asks for — a 1-iteration rung 0 on a noisy host
# otherwise crowns whichever candidate got lucky.
TIMING_REPEATS_FLOOR = 3


def _wait(out) -> None:
    """Block until the card has finished whatever produced ``out`` (a
    tensor or a tuple of them); nothing to wait for on the CPU."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for t in outs:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def _timeit(fn, warmup: int = 1, iters: int = 2,
            min_repeats: Optional[int] = None) -> float:
    """Median wall seconds per call: ``perf_counter`` around the call and
    a ``torch.cuda.synchronize`` on the card's results, so each sample is
    the launch and its run to the end.

    Runs ``max(iters, min_repeats)`` timed repeats (the floor defaults to
    :data:`TIMING_REPEATS_FLOOR`) so a low-iteration successive-halving
    rung still medians away scheduler hiccups instead of ranking on a
    single sample."""
    floor = TIMING_REPEATS_FLOOR if min_repeats is None else min_repeats
    repeats = max(int(iters), int(floor), 1)
    for _ in range(warmup):
        _wait(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


@dataclasses.dataclass
class SearchResult:
    """Outcome + audit trail of one guided search."""

    key: TuneKey
    config: KernelConfig              # the winner (flat view)
    seconds: float                    # its best measured time
    measured: int                     # distinct candidates actually timed
    space: int                        # full candidate-space size
    predicted_rank: Optional[int]     # winner's rank in the cost ordering
    trace: list = dataclasses.field(default_factory=list)
    # trace rows: (config, seconds | None if infeasible at measure time)
    schedule: Optional[Schedule] = None   # the winner as a Schedule


def measured_search(cands: Sequence, measure: Callable,
                    order: Optional[Callable] = None,
                    max_measure: Optional[int] = None,
                    rungs: Sequence[int] = (1, 3),
                    log: Optional[Callable] = None):
    """Successive-halving over ``cands``.

    measure(candidate, iters) -> wall seconds (may raise: the candidate is
    dropped as infeasible). ``order`` ranks candidates cheapest-first
    without running them (the cost model); ``max_measure`` caps how many
    enter rung 0. Each rung times the survivors with ``rungs[i]``
    iterations and keeps the fastest half. Returns
    (best_candidate, best_seconds, trace) with trace = [(cand, secs|None)].
    """
    pool = list(cands)
    if order is not None:
        pool = order(pool)
    if max_measure is not None:
        pool = pool[:max(1, max_measure)]
    trace: list = []
    timed: list = []                          # (seconds, index, cand)
    for r, iters in enumerate(rungs):
        survivors = pool if r == 0 else [c for _, _, c in timed]
        timed = []
        for i, cand in enumerate(survivors):
            try:
                t = measure(cand, iters)
            except Exception:
                if r == 0:
                    trace.append((cand, None))
                continue
            trace.append((cand, t))
            timed.append((t, i, cand))
            if log is not None:
                log(cand, t, r)
        if not timed:
            raise RuntimeError("no feasible candidate survived measurement")
        timed.sort(key=lambda x: x[0])
        if r < len(rungs) - 1:
            timed = timed[:max(1, math.ceil(len(timed) / 2))]
    best_t, _, best = timed[0]
    return best, best_t, trace


# ---------------------------------------------------------------------------
# Schedule-graph solver
# ---------------------------------------------------------------------------
#
# The schedule space is a layered DAG: layer i's nodes are "segments 0..i
# scheduled", an edge through layer i fixes segment i's factorization and
# complex-product algorithm, and every path additionally commits to one
# LANE — the dispatch-global decisions (precision and line block for a
# flat kernel; precision, residency tier, phase block, and DMA buffer
# depth for a megakernel). Edge weights come from cost.segment_seconds /
# cost.turn_seconds (the same roofline terms as cost.predicted_seconds),
# so a uniform path and the equivalent flat KernelConfig are priced by
# bit-identical arithmetic. Uniform-cost (Dijkstra-style) expansion over
# one shared heap emits COMPLETE paths in increasing predicted cost —
# k-shortest enumeration, lazy, so a 6-segment megakernel with 7
# factorization choices per segment never materializes its ~10^5-path
# product space ("Shortest-Path FFT", arXiv 2604.04311).

# backstop against pathological exploration when every path is over the
# shared-memory budget and the caller asked for a large k
_FRONTIER_POP_BUDGET = 500_000


def _lane_schedules(problem: ScheduleProblem, blocks, precisions,
                    residencies, phase_blocks, buffer_depths) -> list:
    """The dispatch-global decision lanes of the schedule DAG."""
    lanes = []
    if problem.mega:
        if residencies is None:
            residencies = (costlib.RESIDENT_VMEM, costlib.RESIDENT_STAGED)
        for prec in precisions:
            for res in residencies:
                if res == costlib.RESIDENT_STAGED:
                    for pb in phase_blocks:
                        for bd in buffer_depths:
                            lanes.append(dict(
                                precision=prec, residency=res,
                                phase_block=pb, buffer_depth=bd))
                else:
                    lanes.append(dict(precision=prec, residency=res))
    else:
        for prec in precisions:
            for blk in blocks:
                lanes.append(dict(precision=prec, block=blk))
    return lanes


def schedule_frontier(problem: ScheduleProblem, *,
                      k: Optional[int] = None,
                      blocks: Sequence[int] = (4, 8, 16),
                      precisions: Sequence[str] = ("f32",),
                      residencies: Optional[Sequence[str]] = None,
                      phase_blocks: Sequence[int] = (8,),
                      buffer_depths: Sequence[int] = (2,),
                      filter_bytes: int = 0,
                      vmem_budget: int = costlib.VMEM_BUDGET_BYTES
                      ) -> list:
    """Solve the schedule DAG: the ``k`` cheapest complete schedules in
    increasing predicted cost (``k=None`` enumerates the whole space —
    fine for flat kernel problems, exponential for multi-segment mega
    problems, so pass ``k`` there).

    Paths the kernels refuse are cut; paths over the shared-memory budget
    are cut like cost.rank's feasibility cut, with the same never-empty
    guarantee: if NO complete path fits the budget, the structurally-
    feasible paths are returned ordered by (footprint, predicted)
    instead."""
    segs = problem.segments
    if not segs:
        raise ValueError("ScheduleProblem has no segments to schedule")
    lanes = _lane_schedules(problem, blocks, precisions, residencies,
                            phase_blocks, buffer_depths)

    # per-(lane, layer) edge sets, weighted once and reused
    edge_cache: dict = {}

    def edges(lane_idx: int, depth: int):
        hit = edge_cache.get((lane_idx, depth))
        if hit is not None:
            return hit
        lane = lanes[lane_idx]
        shape = segs[depth]
        out = []
        for fs in factorizations(problem.seg_n(shape)):
            for kara in (False, True):
                seg = SegmentConfig(
                    n1=fs[0], n2=fs[1],
                    n3=fs[2] if len(fs) > 2 else None, karatsuba=kara)
                w = costlib.segment_seconds(
                    problem, shape, seg, precision=lane.get("precision"),
                    block=lane.get("block"),
                    residency=lane.get("residency"),
                    phase_block=lane.get("phase_block"))
                out.append((w, seg))
        edge_cache[(lane_idx, depth)] = out
        return out

    heap: list = []
    counter = itertools.count()       # insertion-order tie break
    for i, lane in enumerate(lanes):
        # lane-level fixed weight: corner turns + (mega) slab entry/exit
        base = problem.turns() * costlib.turn_seconds(
            problem, residency=lane.get("residency"),
            buffer_depth=lane.get("buffer_depth"),
            precision=lane.get("precision"))
        if problem.mega:
            base += costlib.slab_io_seconds(problem)   # slab entry/exit
        heapq.heappush(heap, (base, next(counter), i, ()))

    feasible: list = []
    over_budget: list = []            # (vmem_bytes, cost, schedule)
    pops = 0
    while heap and (k is None or len(feasible) < k) \
            and pops < _FRONTIER_POP_BUDGET:
        pops += 1
        cost_so_far, _, lane_idx, chosen = heapq.heappop(heap)
        if len(chosen) == len(segs):
            sched = Schedule(segments=chosen, **lanes[lane_idx])
            if costlib.schedule_feasible(sched, problem, filter_bytes,
                                         vmem_budget):
                feasible.append(sched)
            elif costlib.schedule_structurally_feasible(sched, problem):
                over_budget.append((
                    costlib.schedule_vmem_bytes(sched, problem,
                                                filter_bytes),
                    cost_so_far, sched))
            continue
        for w, seg in edges(lane_idx, len(chosen)):
            heapq.heappush(heap, (cost_so_far + w, next(counter),
                                  lane_idx, chosen + (seg,)))
    if feasible:
        return feasible               # popped in increasing cost already
    over_budget.sort(key=lambda t: (t[0], t[1]))
    out = [s for _, _, s in over_budget]
    return out[:k] if k is not None else out


def _key_device(key: Optional[TuneKey]):
    """Where a key's measurements run: the CPU for a "cpu" key, else the
    card (``resolve_device``: raises without one)."""
    if key is not None and key.backend == "cpu":
        return torch.device("cpu")
    return resolve_device(None)


def _tensor(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def _default_gate(precision: str, key: TuneKey) -> float:
    """The measured SNR gate at the key's own N (``test_scene(key.n)``) on
    the key's device. The reference gates at 256^2 whatever the key; on
    the card bs16 clears 0.1 dB there and overflows f16's range at
    4096^2, so a gate at another size would admit what the key's scenes
    cannot run."""
    from repro_torch.tuning import quality   # deferred: pulls in core.sar
    return quality.precision_snr_deviation(
        precision, n=key.n, device=str(_key_device(key)))


def kernel_measure(key: TuneKey, seed: int = 0) -> Callable:
    """measure(config, iters) for the fused fwd+inv rows launch — the
    workload the reference's tuner times — on the key's device, inputs
    drawn from a seeded numpy generator."""
    from repro_torch.kernels import ops       # deferred: keeps import light
    rng = np.random.default_rng(seed)
    dev = _key_device(key)
    shape = (key.batch, key.lines, key.n)
    xr = _tensor(rng, shape, dev)
    xi = _tensor(rng, shape, dev)
    hr = _tensor(rng, key.n, dev)
    hi = _tensor(rng, key.n, dev)

    def measure(config: KernelConfig, iters: int) -> float:
        kw = config.spectral_kwargs()
        return _timeit(lambda: ops.fused_fft_mult_ifft_rows(
            xr, xi, hr, hi, **kw), warmup=1, iters=iters)

    return measure


def search_kernel(key: TuneKey, *,
                  precisions: Sequence[str] = ("f32",),
                  blocks: Sequence[int] = (4, 8, 16),
                  snr_gate_db: float = DEFAULT_SNR_GATE_DB,
                  gate: Optional[Callable] = None,
                  measure: Optional[Callable] = None,
                  measure_fraction: float = 0.6,
                  rungs: Sequence[int] = (1, 2),
                  cache: Optional[cachelib.TuneCache] = None,
                  persist: bool = True,
                  log: Optional[Callable] = None) -> SearchResult:
    """Guided search for the best kernel config at ``key``; persists the
    winner to the shared cache (so plan compiles and serving warms on any
    later process reuse it).

    ``measure_fraction`` bounds the measured set to that fraction of the
    feasible space (at least 3): the cost model decides WHICH fraction.
    The 0.6 default leaves headroom for measurement noise around
    near-tied configs while still timing strictly fewer candidates than
    the exhaustive sweep. Non-f32 precisions are admitted only if
    ``gate`` (default: the measured point-target SNR deviation on a scene
    of the key's N, ``_default_gate``) stays <= ``snr_gate_db``.
    """
    space = candidates(key.n, blocks=blocks, precisions=tuple(precisions))
    space_size = len(space)

    admitted: dict = {}
    pool = []
    for c in space:
        p = c.precision or "f32"
        if p != "f32":
            if p not in admitted:
                dev = (gate(p) if gate is not None
                       else _default_gate(p, key))
                admitted[p] = dev <= snr_gate_db
                if log is not None:
                    log(f"gate_{p}", dev, admitted[p])
            if not admitted[p]:
                continue
        pool.append(c)

    # Solve the (degenerate, one-segment) schedule DAG for this key: the
    # frontier's flat-config views are the schedulable subset of the
    # product space. Keeping the pool in candidates() order and ranking
    # through cost.rank preserves the legacy ordering bit-for-bit — the
    # graph search strictly generalizes the flat sweep, it never times
    # more than it.
    problem = ScheduleProblem.kernel(key.n, batch=key.batch,
                                     lines=key.lines)
    gated_precisions = tuple(
        p for p in dict.fromkeys(c.precision or "f32" for c in pool))
    frontier = schedule_frontier(problem, blocks=tuple(blocks),
                                 precisions=gated_precisions or ("f32",))
    allowed = {s.to_config() for s in frontier}
    pool = [c for c in pool if c in allowed]

    ranked = costlib.rank(pool, key)
    if not ranked:
        raise RuntimeError(f"feasibility cut emptied the space for {key}")
    max_measure = max(3, math.ceil(len(ranked) * measure_fraction))
    max_measure = min(max_measure, len(ranked))

    measure = measure or kernel_measure(key)
    best, best_t, trace = measured_search(
        ranked, measure, max_measure=max_measure, rungs=rungs,
        log=(lambda c, t, r: log(c, t, r)) if log is not None else None)

    measured = len({c for c, t in trace if t is not None})
    result = SearchResult(
        key=key, config=best, seconds=best_t, measured=measured,
        space=space_size, predicted_rank=ranked.index(best), trace=trace,
        schedule=Schedule.from_config(best))
    if persist:
        (cache or cachelib.get_cache()).put(key, best, seconds=best_t,
                                            source="search")
    return result


# ---------------------------------------------------------------------------
# Megakernel schedule search
# ---------------------------------------------------------------------------

def mega_measure(problem: ScheduleProblem, seed: int = 0,
                 device=None) -> Callable:
    """measure(schedule, iters) for a cross-axis megakernel problem:
    times ops.mega_spectral_op with the schedule's per-segment
    factorizations/karatsuba carried in extended segment tuples, on
    ``device`` (None: the card), inputs drawn from a seeded numpy
    generator."""
    from repro_torch.kernels import ops       # deferred: keeps import light
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    shape = (problem.batch, problem.na, problem.nr)
    xr = _tensor(rng, shape, dev)
    xi = _tensor(rng, shape, dev)
    filters = []
    modes = []
    for s in problem.segments:
        modes.append("shared" if s.filtered else "none")
        if s.filtered:
            n = problem.seg_n(s)
            filters.append(_tensor(rng, n, dev))
            filters.append(_tensor(rng, n, dev))

    def measure(schedule: Schedule, iters: int) -> float:
        segments = tuple(
            (s.axis, s.fwd, s.inv, modes[i],
             schedule.segment(i).n1, schedule.segment(i).n2,
             schedule.segment(i).n3, schedule.segment(i).karatsuba)
            for i, s in enumerate(problem.segments))
        kw = dict(segments=segments)
        if schedule.residency is not None:
            kw["residency"] = schedule.residency
        if schedule.phase_block is not None:
            kw["phase_block"] = schedule.phase_block
        if schedule.buffer_depth is not None:
            kw["buffer_depth"] = schedule.buffer_depth
        if schedule.precision is not None:
            kw["precision"] = schedule.precision
        return _timeit(lambda: ops.mega_spectral_op(xr, xi, *filters, **kw),
                       warmup=1, iters=iters)

    return measure


def search_schedule(problem: ScheduleProblem, key: Optional[TuneKey] = None,
                    *, k: int = 8,
                    measure: Optional[Callable] = None,
                    rungs: Sequence[int] = (1, 2),
                    cache: Optional[cachelib.TuneCache] = None,
                    persist: bool = True,
                    log: Optional[Callable] = None,
                    **frontier_kw) -> SearchResult:
    """Graph-guided schedule search for a multi-segment problem: solve
    the DAG for the ``k`` cheapest schedules, refine them through the
    same successive-halving engine the flat tuner uses, persist the
    winning Schedule (schema-2 cache) under ``key``.

    This is the search the flat ``candidates()`` sweep cannot express:
    the frontier's paths may give every segment its own factorization and
    complex-product algorithm."""
    frontier = schedule_frontier(problem, k=k, **frontier_kw)
    if not frontier:
        raise RuntimeError(
            f"schedule graph produced no feasible path for {problem}")
    measure = measure or mega_measure(problem, device=_key_device(key))
    best, best_t, trace = measured_search(
        frontier, measure, rungs=rungs,
        log=(lambda c, t, r: log(c, t, r)) if log is not None else None)
    measured = len({s for s, t in trace if t is not None})
    result = SearchResult(
        key=key, config=best.to_config(), seconds=best_t,
        measured=measured, space=len(frontier),
        predicted_rank=frontier.index(best), trace=trace, schedule=best)
    if persist and key is not None:
        (cache or cachelib.get_cache()).put_schedule(
            key, best, seconds=best_t, source="search")
    return result


# ---------------------------------------------------------------------------
# Lookups — the compile-time path (never sweeps) and the cached-or-tuned path
# ---------------------------------------------------------------------------

def _lookup_key(n: int, batch: int, lines: int, device) -> TuneKey:
    """The kernel key of (n, batch-bucket) on ``device`` (None: the card
    when there is one, else the CPU)."""
    return TuneKey.kernel(n, batch, lines=lines,
                          backend=default_backend(device),
                          device=device_fingerprint(device))


def cached_config(n: int, batch: int = 1, lines: int = 16,
                  cache: Optional[cachelib.TuneCache] = None,
                  device=None) -> Optional[KernelConfig]:
    """Best-known kernel config for (n, batch-bucket) on THIS device (or
    ``device``), or None. Pure cache lookup — compile time must never
    trigger a sweep."""
    try:
        key = _lookup_key(n, batch, lines, device)
        return (cache or cachelib.get_cache()).get(key)
    except Exception:
        return None


def cached_schedule(n: int, batch: int = 1, lines: int = 16,
                    cache: Optional[cachelib.TuneCache] = None,
                    device=None) -> Optional[Schedule]:
    """Best-known Schedule for (n, batch-bucket) on THIS device (or
    ``device``), or None. A flat (schema-1-migrated) entry resolves as its
    degenerate one-segment schedule — no re-search. Pure lookup, like
    :func:`cached_config`."""
    try:
        key = _lookup_key(n, batch, lines, device)
        return (cache or cachelib.get_cache()).get_schedule(key)
    except Exception:
        return None


def best_config(n: int, batch: int = 1, lines: int = 16,
                tune_missing: bool = True,
                cache: Optional[cachelib.TuneCache] = None,
                **search_kw) -> KernelConfig:
    """Cached best config for (n, batch); runs the guided search on a
    miss (``tune_missing=False`` falls back to library defaults)."""
    key = TuneKey.kernel(n, batch, lines=lines)
    hit = (cache or cachelib.get_cache()).get(key)
    if hit is not None:
        return hit
    if tune_missing:
        return search_kernel(key, cache=cache, **search_kw).config
    return KernelConfig(block=8)
