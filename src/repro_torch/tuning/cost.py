"""Analytic cost model of fused spectral launches on the H100 (the port's
counterpart of the JAX package's ``repro.tuning.cost``: the same names,
the same ranking contract, Hopper terms in place of a TPU's).

Ranks :class:`~repro_torch.tuning.space.KernelConfig` candidates WITHOUT
running them, so the measured search (search.py) times only the promising
few. Ranking, not prediction, is the contract; the measured rungs decide.

The model prices one fused ``[FFT] · H · [IFFT]`` launch of the matmul
route's CUDA kernel (``csrc/spectral.cu``) on a ``(batch, lines, n)`` slab
as the SUM of its compute and its memory time: a block of the kernel loads
its tile, runs its stages and stores the tile in turn, without overlap
(PERF.md §5), so the two add rather than take a roofline maximum.

**Tensor-core stages.** Stage ``i`` of the four-step contracts every
length-``n`` line with an ``f_i × f_i`` DFT matrix: ``8 n f_i`` real FLOPs
a line (``6 n f_i`` with Karatsuba's three real products), issued as
``mma.sync`` tiles of 16 rows and 8 (TF32) or 16 (bf16 / f16) k-values, so
a factor below the tile runs at ``f / 16`` (and ``f / k``) of the rate.
f32 is three TF32 passes at the TF32 rate ``mma.sync`` reaches
(``MMA_SYNC_TF32_FLOPS``, measured); bf16 and f16 one pass at twice it
(the spec sheet's dense BF16 / FP16 rate over its dense TF32 rate), which
``_PRECISION_SPEEDUP`` derives. Twiddles, the filter and the bs16 codec
run on the FP32 cores.

**Bytes.** The slab is read and written once a launch (16 B a point), and
every block copies F1 and F2 and reads the twiddles (``_const_bytes``), one
block a tile of ``ops.kernel_tile``'s lines. ``block`` only pads lines
(``ops.spectral_op``); the tile does not depend on it, so configs that
launch the same kernel on the same padded slab are priced alike, and the
measured rungs choose among them. Narrow operands do not shrink device
memory traffic (the slab stays f32).

**Feasibility.** A config is cut when the CUDA kernels refuse it
(``ops.check_kernel_spec``, ``ops.check_mega_kernel``: N > 4096 or a split
of three factors) or its block's shared memory exceeds the 232,448 B a
block may opt in to (``ops.SMEM_OPTIN_BYTES``), so nothing the cut admits
raises at launch.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.kernels import ops
from repro_torch.kernels.fft4step import (
    FILTER_NONE,
    FILTER_SHARED,
    MAX_FACTOR,
    RESIDENT_STAGED,
    RESIDENT_VMEM,
    MegaSpec,
    SegmentSpec,
    SpectralSpec,
    check_mega,
    default_factorization,
    flops_nominal,
    resolve_precision,
)
from repro_torch.tuning.space import (
    KernelConfig,
    Schedule,
    ScheduleProblem,
    SegmentConfig,
    SegmentShape,
    TuneKey,
    bucket_batch,
)

# The H100 SXM's rates (NVIDIA's spec sheet), but for MMA_SYNC_TF32_FLOPS.
HBM_BYTES_PER_S = 3.35e12          # HBM3 (spec sheet)
FP32_FLOPS = 67e12                 # FP32 outside the tensor cores (spec sheet)
TF32_DENSE_FLOPS = 495e12          # dense TF32 tensor cores (spec sheet)
BF16_DENSE_FLOPS = 989e12          # dense BF16 and FP16 (spec sheet)
# What mma.sync.m16n8k8 TF32 reaches on its own, measured with
# repro_torch.kernels.probe on an H100 80GB HBM3 at a 700 W power limit
# (PERF.md §3): the matmul route's stages issue mma.sync, not wgmma.
MMA_SYNC_TF32_FLOPS = 319.87e12
TF32_PASSES = 3                    # f32 as 3xTF32 (csrc/tf32_mma.cuh)
# The on-chip budget: shared memory one block may opt in to.
SMEM_BUDGET_BYTES = ops.SMEM_OPTIN_BYTES

# The reference's names for the same roles.
PEAK_MATMUL_FLOPS = MMA_SYNC_TF32_FLOPS / TF32_PASSES   # f32 stages
PEAK_VPU_FLOPS = FP32_FLOPS
PEAK_HBM_BYTES = HBM_BYTES_PER_S
VMEM_BUDGET_BYTES = SMEM_BUDGET_BYTES

# Stage throughput per operand precision over f32's: f32 pays three TF32
# passes; bf16 and f16 (and bs16, f16 behind the codec) one pass at the
# dense BF16 / FP16 rate, twice the TF32 rate.
_NARROW = TF32_PASSES * BF16_DENSE_FLOPS / TF32_DENSE_FLOPS
_PRECISION_SPEEDUP = {"f32": 1.0, "bf16": _NARROW, "f16": _NARROW,
                      "bs16": _NARROW}
# mma.sync tile: 16 rows of F, k-steps of 8 (TF32) or 16 (bf16 / f16)
_MMA_ROWS = 16
_MMA_K = {"f32": 8, "bf16": 16, "f16": 16, "bs16": 16}


def _factors(config: KernelConfig, n: int) -> tuple:
    return config.factors() or default_factorization(n)


def _const_bytes(factors: tuple) -> int:
    """DFT matrices + inter-stage twiddles, split re/im float32 — what
    every block of a launch reads."""
    b = sum(2 * 4 * f * f for f in factors)
    for i in range(len(factors) - 1):
        rest = math.prod(factors[i + 1:])
        b += 2 * 4 * factors[i] * rest
    return b


def _spec(n: int, config, axis: int = 1, fwd: bool = True,
          inv: bool = True, filtered: bool = True) -> SpectralSpec:
    fs = _factors(config, n)
    return SpectralSpec(
        n=n, fwd=fwd, inv=inv,
        filter_mode=FILTER_SHARED if filtered else FILTER_NONE, axis=axis,
        n1=fs[0], n2=fs[1] if len(fs) > 1 else None,
        n3=fs[2] if len(fs) > 2 else None,
        karatsuba=bool(config.karatsuba),
        precision=resolve_precision(config.precision).name)


def _kernel_split(spec: SpectralSpec) -> Optional[tuple]:
    """The kernel's split of ``spec``, or None where it refuses it."""
    try:
        return ops.check_kernel_spec(spec)
    except ValueError:
        return None


def vmem_bytes(config: KernelConfig, key: TuneKey) -> int:
    """Shared memory of one block of the rows launch (its tile, F1 and F2,
    and a bs16 exponent a line); a split the kernel refuses is priced at
    its tile and constants alone."""
    fs = _factors(config, key.n)
    n1, n2 = fs[0], math.prod(fs[1:])
    tile = ops.kernel_tile(key.n, 1, "matmul", n1, n2)[0]
    smem = tile * key.n * 8 + ops.dft_smem_bytes(n1, n2)
    if resolve_precision(config.precision).block_scaled:
        smem += 4 * tile
    return smem


def structurally_feasible(config: KernelConfig, key: TuneKey) -> bool:
    """The config builds a launch the CUDA kernel takes for ``key``."""
    n = key.n
    fs = _factors(config, n)
    if math.prod(fs) != n:
        return False
    if any(f > MAX_FACTOR or f & (f - 1) for f in fs):
        return False
    if _kernel_split(_spec(n, config)) is None:
        return False
    block = config.block or 8
    # ops.spectral_op PADS lines up to a block multiple, so a block that
    # does not divide lines is still runnable (the pad is timed, and
    # priced, honestly); only block > lines is pure waste — the whole
    # launch would be mostly padding. Same rule as the reference's.
    if block > key.lines and key.lines % block:
        return False
    return True


def feasible(config: KernelConfig, key: TuneKey,
             vmem_budget: int = VMEM_BUDGET_BYTES) -> bool:
    """Structural + shared-memory feasibility (never measured if False)."""
    return structurally_feasible(config, key) and \
        vmem_bytes(config, key) <= vmem_budget


def _stage_seconds(n: int, lines_total: int, factors: tuple, karatsuba,
                   precision: str, transforms: int) -> float:
    """The tensor-core stages of ``transforms`` transforms of every line."""
    rate = PEAK_MATMUL_FLOPS * _PRECISION_SPEEDUP[precision]
    mac_flops = 6.0 if karatsuba else 8.0
    t = 0.0
    for f in factors:
        util = min(1.0, f / _MMA_ROWS) * min(1.0, f / _MMA_K[precision])
        t += transforms * lines_total * mac_flops * n * f / (rate * util)
    return t


def _dispatch_terms(*, n: int, lines: int, batch: int, factors: tuple,
                    karatsuba, precision, transforms: int, filtered: bool,
                    block: Optional[int], tile: Optional[int] = None,
                    slab_io: bool = True) -> dict:
    """The cost ingredients of one launch (or one megakernel phase),
    itemized: ``predicted_seconds`` (flat configs), the schedule-graph
    edge weights (``segment_seconds``) and ``cost_breakdown`` all price
    through this one function.

    ``block`` pads the lines (None: no padding); ``tile`` is the lines a
    block holds (one constants read each; None: ``ops.kernel_tile``'s);
    ``slab_io``: the launch reads and writes its slab (a megakernel's
    segment does not: its scene crosses device memory at the entry, the
    exit and each turn, priced by the schedule)."""
    prec = resolve_precision(precision).name
    padded = lines if block is None else math.ceil(lines / block) * block
    lines_total = batch * padded
    matmul = _stage_seconds(n, lines_total, factors, karatsuba, prec,
                            transforms)
    # twiddles (one complex multiply per point per stage boundary), the
    # filter multiply and the bs16 codec (a max and two scalings a point)
    # on the FP32 cores
    pointwise = transforms * (len(factors) - 1) * 6.0 * n * lines_total
    if filtered:
        pointwise += 6.0 * n * lines_total
    if resolve_precision(prec).block_scaled:
        pointwise += 6.0 * n * lines_total
    vpu = pointwise / PEAK_VPU_FLOPS
    compute = matmul + vpu

    if tile is None:
        n1, n2 = factors[0], math.prod(factors[1:])
        tile = ops.kernel_tile(n, 1, "matmul", n1, n2)[0]
    blocks = batch * max(1, math.ceil(padded / tile))
    bytes_moved = blocks * _const_bytes(factors)
    if slab_io:
        bytes_moved += 2 * 2 * 4 * n * lines_total    # x and y, re+im f32
    if filtered:
        bytes_moved += 2 * 4 * n                       # shared filter
    memory = bytes_moved / PEAK_HBM_BYTES

    return {
        "matmul_seconds": matmul,
        "vpu_seconds": vpu,
        "compute_seconds": compute,
        "bytes_moved": bytes_moved,
        "memory_seconds": memory,
        "predicted_seconds": compute + memory,
    }


def _flat_terms(config: KernelConfig, key: TuneKey, fwd: bool, inv: bool,
                filtered: bool) -> dict:
    return _dispatch_terms(
        n=key.n, lines=key.lines, batch=key.batch,
        factors=_factors(config, key.n), karatsuba=config.karatsuba,
        precision=config.precision,
        transforms=(1 if fwd else 0) + (1 if inv else 0),
        filtered=filtered, block=config.block or 8)


def predicted_seconds(config: KernelConfig, key: TuneKey,
                      fwd: bool = True, inv: bool = True,
                      filtered: bool = True) -> float:
    """Time estimate for one fused launch under ``config``. Relative
    ordering is the contract (search.py measures the top of the
    ranking); see the module docstring for the model."""
    return _flat_terms(config, key, fwd, inv, filtered)["predicted_seconds"]


def cost_breakdown(config: KernelConfig, key: TuneKey,
                   fwd: bool = True, inv: bool = True,
                   filtered: bool = True,
                   vmem_budget: int = VMEM_BUDGET_BYTES) -> dict:
    """The itemized verdict on one candidate: tensor-core vs FP32 vs bytes
    seconds, the total, and both feasibility cuts."""
    terms = _flat_terms(config, key, fwd, inv, filtered)
    vb = vmem_bytes(config, key)
    terms.update({
        "vmem_bytes": vb,
        "vmem_feasible": vb <= vmem_budget,
        "structurally_feasible": structurally_feasible(config, key),
    })
    return terms


# ---------------------------------------------------------------------------
# Megakernel (fused1) residency
# ---------------------------------------------------------------------------
#
# One cut, the kernels' own: a scene whose split f32 slab fits one block's
# shared memory (128^2 and smaller) runs mega_resident, every larger one
# mega_staged (ops.mega_residency).

mega_residency = ops.mega_residency


def mega_vmem_bytes(na: int, nr: int, batch_block: int = 1,
                    precision: Optional[str] = None,
                    filter_bytes: int = 0) -> int:
    """Shared memory of one mega_resident block: the split f32 slab (8 B a
    point, at every precision) and, for bs16, an exponent a line. The DFT
    constants and the filters are read in place from device memory, so
    ``filter_bytes`` takes none."""
    del filter_bytes
    smem = 8 * (batch_block or 1) * na * nr
    if resolve_precision(precision).block_scaled:
        smem += 4 * max(na, nr)
    return smem


def _staged_phase_bytes(n: int, lines: int, axis: int, factors: tuple,
                        precision: Optional[str] = None) -> int:
    """Shared memory of one mega_staged phase on the matmul route."""
    n1, n2 = factors[0], math.prod(factors[1:])
    tile = ops.staged_tile(n, lines, "matmul", n1, n2, axis)
    smem = tile * n * 8 + ops.dft_smem_bytes(n1, n2)
    if resolve_precision(precision).block_scaled:
        smem += 4 * tile
    return smem


def staged_vmem_bytes(na: int, nr: int, phase_block: int = 8,
                      filter_bytes: int = 0) -> int:
    """Shared memory of a mega_staged block on the default splits: the
    larger of its row and column phases (a tile of whole lines, F1 and
    F2). ``phase_block`` is validated by the kernel but does not shape its
    tiles; the filters are read in place."""
    del phase_block, filter_bytes
    return max(_staged_phase_bytes(nr, na, 1, default_factorization(nr)),
               _staged_phase_bytes(na, nr, 0, default_factorization(na)))


# ---------------------------------------------------------------------------
# Schedule-graph edge weights
# ---------------------------------------------------------------------------
#
# The same decomposition as the reference's: a weight per segment edge, a
# weight per corner turn, and the scene's entry and exit. On the card a
# resident slab turns in shared memory (free); a staged one writes the
# scene to device memory and reads it back at each turn, with no overlap
# (mega_staged does not prefetch: buffer_depth is validated only).

# fraction of a staged turn's traffic left on the critical path: all of it
TURN_OVERLAP = 1.0


def segment_seconds(problem: ScheduleProblem, shape: SegmentShape,
                    seg: SegmentConfig, *, precision=None,
                    karatsuba=None, block: Optional[int] = None,
                    residency: Optional[str] = None,
                    phase_block: Optional[int] = None) -> float:
    """Seconds for ONE schedule-DAG segment edge: a whole launch on a flat
    problem; on a megakernel the segment's stages and its constants (its
    scene's device-memory traffic is priced by the turns and the entry
    and exit), one constants read per scene resident, per tile staged."""
    n = problem.seg_n(shape)
    lines = problem.seg_lines(shape)
    fs = seg.factors() or default_factorization(n)
    kara = seg.karatsuba if seg.karatsuba is not None else karatsuba
    transforms = (1 if shape.fwd else 0) + (1 if shape.inv else 0)
    kw = dict(n=n, lines=lines, batch=problem.batch, factors=fs,
              karatsuba=kara, precision=precision, transforms=transforms,
              filtered=shape.filtered)
    if not problem.mega:
        return _dispatch_terms(block=block or 8,
                               **kw)["predicted_seconds"]
    del phase_block
    if residency == RESIDENT_VMEM:
        tile = lines
    else:
        tile = ops.staged_tile(n, lines, "matmul", fs[0],
                               math.prod(fs[1:]), shape.axis)
    return _dispatch_terms(block=None, tile=tile, slab_io=False,
                           **kw)["predicted_seconds"]


def turn_seconds(problem: ScheduleProblem, *,
                 residency: Optional[str] = None,
                 buffer_depth: Optional[int] = None,
                 precision: Optional[str] = None) -> float:
    """The corner-turn edge weight between two segments on different
    axes: free for a resident slab (its turn is a change of strides in
    shared memory), a device-memory write and read of the scene for the
    staged kernel. No overlap credit: no kernel of the port prefetches
    (``buffer_depth`` is validated only)."""
    del buffer_depth, precision
    if residency != RESIDENT_STAGED:
        return 0.0
    traffic = 2 * 2 * 4 * problem.na * problem.nr * problem.batch
    return traffic / PEAK_HBM_BYTES * TURN_OVERLAP


def _mega_spec(schedule: Schedule, problem: ScheduleProblem) -> MegaSpec:
    """The MegaSpec a scheduled megakernel launch checks: each segment's
    split and Karatsuba in its record, the lane's residency (the cut's
    when deferred) and precision."""
    segs = []
    for i, shape in enumerate(problem.segments):
        sc = schedule.segment(i)
        fs = sc.factors() or default_factorization(problem.seg_n(shape))
        segs.append(SegmentSpec(
            axis=shape.axis, fwd=shape.fwd, inv=shape.inv,
            filter_mode=FILTER_SHARED if shape.filtered else FILTER_NONE,
            n1=fs[0], n2=fs[1] if len(fs) > 1 else None,
            n3=fs[2] if len(fs) > 2 else None, karatsuba=sc.karatsuba))
    precision = resolve_precision(schedule.precision).name
    residency = schedule.residency or mega_residency(
        problem.na, problem.nr, precision=precision)
    return MegaSpec(
        na=problem.na, nr=problem.nr, segments=tuple(segs),
        residency=residency, phase_block=schedule.phase_block or 8,
        buffer_depth=schedule.buffer_depth or 2, precision=precision)


def schedule_vmem_bytes(schedule: Schedule,
                        problem: ScheduleProblem,
                        filter_bytes: int = 0) -> int:
    """Shared memory of one block under a whole schedule: flat problems
    through ``vmem_bytes``; a resident megakernel its slab, a staged one
    its largest phase (each segment's own split)."""
    if not problem.mega:
        key = TuneKey(kind="kernel", backend="-", device="-",
                      n=problem.nr, batch=bucket_batch(problem.batch),
                      lines=problem.na)
        return vmem_bytes(schedule.to_config(), key)
    if schedule.residency == RESIDENT_VMEM:
        return mega_vmem_bytes(problem.na, problem.nr, 1,
                               schedule.precision, filter_bytes)
    out = 0
    for i, shape in enumerate(problem.segments):
        n = problem.seg_n(shape)
        fs = schedule.segment(i).factors() or default_factorization(n)
        out = max(out, _staged_phase_bytes(n, problem.seg_lines(shape),
                                           shape.axis, fs,
                                           schedule.precision))
    return out


def schedule_structurally_feasible(schedule: Schedule,
                                   problem: ScheduleProblem) -> bool:
    """The schedule builds launches the CUDA kernels take: every segment's
    split a valid one for its length that the spectral kernel takes, and
    on a megakernel the whole launch ``ops.check_mega_kernel`` (and the
    residency's shape rules, ``fft4step.check_mega``) takes."""
    for i, shape in enumerate(problem.segments):
        n = problem.seg_n(shape)
        sc = schedule.segment(i)
        fs = sc.factors() or default_factorization(n)
        if math.prod(fs) != n:
            return False
        if any(f > MAX_FACTOR or f & (f - 1) for f in fs):
            return False
        cfg = KernelConfig(n1=fs[0], n2=fs[1] if len(fs) > 1 else None,
                           n3=fs[2] if len(fs) > 2 else None,
                           karatsuba=sc.karatsuba,
                           precision=schedule.precision)
        if (shape.fwd or shape.inv) and _kernel_split(_spec(
                n, cfg, shape.axis, shape.fwd, shape.inv,
                shape.filtered)) is None:
            return False
    if not problem.mega:
        block = schedule.block or 8
        lines = problem.na
        if block > lines and lines % block:
            return False
        return True
    try:
        spec = _mega_spec(schedule, problem)
        ops.check_mega_kernel(spec)
        check_mega(spec, problem.batch)
    except ValueError:
        return False
    return True


def schedule_feasible(schedule: Schedule, problem: ScheduleProblem,
                      filter_bytes: int = 0,
                      vmem_budget: int = VMEM_BUDGET_BYTES) -> bool:
    """Structural + shared-memory feasibility of a complete schedule."""
    return schedule_structurally_feasible(schedule, problem) and \
        schedule_vmem_bytes(schedule, problem, filter_bytes) <= vmem_budget


def slab_io_seconds(problem: ScheduleProblem) -> float:
    """A megakernel's scene in and out of device memory once."""
    return (2 * 2 * 4 * problem.na * problem.nr * problem.batch
            / PEAK_HBM_BYTES)


def schedule_seconds(schedule: Schedule,
                     problem: ScheduleProblem) -> float:
    """Predicted seconds of a complete schedule: the sum of the SAME
    per-segment and per-turn edge weights the graph search accumulates
    (plus, for mega problems, the scene's one entry and exit)."""
    total = 0.0
    for i, shape in enumerate(problem.segments):
        total += segment_seconds(
            problem, shape, schedule.segment(i),
            precision=schedule.precision, block=schedule.block,
            residency=schedule.residency,
            phase_block=schedule.phase_block)
    prev = None
    for shape in problem.segments:
        if prev is not None and prev.axis != shape.axis:
            total += turn_seconds(problem, residency=schedule.residency,
                                  buffer_depth=schedule.buffer_depth,
                                  precision=schedule.precision)
        prev = shape
    if problem.mega:
        total += slab_io_seconds(problem)
    return total


# RDA-family megakernel shape (fused1 / csa_fused1 / omegak_fused1 all
# lower to an azimuth -> range -> azimuth segment chain): the canonical
# workload ``serve_batch_seconds`` prices.
_MEGA_SEGMENTS_2D = (
    SegmentShape(axis=0, fwd=True, inv=False, filtered=False),
    SegmentShape(axis=1, fwd=True, inv=True, filtered=True),
    SegmentShape(axis=0, fwd=False, inv=True, filtered=True),
)


def serve_batch_seconds(na: int, nr: int, batch: int = 1,
                        precision: Optional[str] = None,
                        streamed: bool = False) -> float:
    """Predicted seconds of ONE served micro-batch — the worker pool's
    lane-routing weight (``repro_torch.service.workers.WorkerPool.route``).

    Prices the canonical azimuth->range->azimuth megakernel (the shape
    every served RDA-family variant lowers to) with
    :func:`schedule_seconds`, at the residency the compiler would pick for
    the scene (``mega_residency``) — pinned to the staged tier for
    ``streamed`` keys, whose scenes are over the device budget by
    definition. Relative ordering across keys is the contract, as for the
    kernel search: a 1024² batch must weigh a lane's backlog more than a
    256² one, by roughly the model's ratio."""
    problem = ScheduleProblem.mega_2d(na, nr, _MEGA_SEGMENTS_2D,
                                      batch=max(1, batch))
    res = (RESIDENT_STAGED if streamed
           else mega_residency(na, nr, precision=precision))
    sched = Schedule(
        segments=(SegmentConfig(),) * len(_MEGA_SEGMENTS_2D),
        precision=precision, residency=res, phase_block=8, buffer_depth=2)
    return schedule_seconds(sched, problem)


def nominal_flops(key: TuneKey, fwd: bool = True, inv: bool = True,
                  filtered: bool = True) -> float:
    """The algorithmic 5 n log2 n count (``fft4step.flops_nominal``) for
    the whole slab — the numerator of reported efficiency, not the cost."""
    spec = SpectralSpec(
        n=key.n, fwd=fwd, inv=inv,
        filter_mode=FILTER_SHARED if filtered else FILTER_NONE)
    return flops_nominal(spec, key.lines, key.batch)


def rank(configs, key: TuneKey, vmem_budget: int = VMEM_BUDGET_BYTES,
         **kw) -> list:
    """Feasible configs sorted by predicted cost, cheapest first. Where
    the shared-memory cut would exclude EVERY candidate, the cut falls
    back to structural feasibility (what the kernel takes) with the
    footprint folded into the ordering; a problem the kernel takes in no
    config (N > 4096) ranks nothing."""
    feas = [c for c in configs if feasible(c, key, vmem_budget)]
    if feas:
        return sorted(feas, key=lambda c: predicted_seconds(c, key, **kw))
    feas = [c for c in configs if structurally_feasible(c, key)]
    return sorted(feas, key=lambda c: (vmem_bytes(c, key),
                                       predicted_seconds(c, key, **kw)))
