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
block a tile of ``ops.kernel_tile``'s lines. A line past one block (N >
4096) or a three-factor split runs as passes over device memory
(``ops.long_geometry``): each device-memory digit adds one more read and
write of the slab a transform, except on the rows layout with one digit
and N <= 16384, where the passes run in a whole-line tile and the slab
is read and written once (``LongGeometry.whole_line``); in a resident
megakernel the same passes run over the slab in shared memory
(``SMEM_BYTES_PER_S``). ``block`` only
pads lines
(``ops.spectral_op``); the tile does not depend on it, so configs that
launch the same kernel on the same padded slab are priced alike, and the
measured rungs choose among them. Narrow operands do not shrink device
memory traffic (the slab stays f32).

**Feasibility.** A config is cut when the CUDA kernels refuse it
(``ops.check_kernel_spec``, ``ops.check_mega_kernel``: a split no route
takes, a resident slab that does not fit one block) or its
block's shared memory exceeds the 232,448 B a block may opt in to
(``ops.SMEM_OPTIN_BYTES``; a long op's largest pass,
``LongGeometry.smem_bytes``), so nothing the cut admits raises at
launch.
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
# Shared memory's rate over the card, derived: 32 banks of 4 B a clock an
# SM x 132 SMs x the 1.98 GHz boost clock (spec sheet).
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
# One card's NVLink 4 egress: the spec sheet's 900 GB/s is both directions
# together, and a corner turn's all_to_all is priced by what each device
# sends, so half of it.
PEAK_LINK_BYTES = 450e9
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


def _long(n: int, factors: tuple, precision: Optional[str] = None,
          axis: int = 1):
    """The device-memory passes of an op of this split, precision and
    layout (``ops.long_geometry``: the 16-bit forms take each factor in
    one stage; the rows layout with one digit runs whole-line tiles), or
    None for a line of one block or a split no kernel takes."""
    try:
        return ops.long_geometry(SpectralSpec(
            n=n, fwd=True, inv=True, filter_mode=FILTER_NONE, axis=axis,
            n1=factors[0], n2=factors[1] if len(factors) > 1 else None,
            n3=factors[2] if len(factors) > 2 else None,
            precision=resolve_precision(precision).name))
    except ValueError:
        return None


def vmem_bytes(config: KernelConfig, key: TuneKey) -> int:
    """Shared memory of one block of the rows launch (its tile, F1 and F2,
    and a bs16 exponent a line; a long op's largest pass); a split the
    kernel refuses is priced at its tile and constants alone."""
    fs = _factors(config, key.n)
    geom = _long(key.n, fs, config.precision)
    if geom is not None:
        return geom.smem_bytes()
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


def _stage_flops(n: int, lines_total: int, factors: tuple, karatsuba,
                 transforms: int) -> float:
    """The tensor-core stages' FLOPs of ``transforms`` transforms of
    every line (``_stage_seconds``' numerator)."""
    mac_flops = 6.0 if karatsuba else 8.0
    return sum(transforms * lines_total * mac_flops * n * f
               for f in factors)


def _dispatch_terms(*, n: int, lines: int, batch: int, factors: tuple,
                    karatsuba, precision, transforms: int, filtered: bool,
                    block: Optional[int], tile: Optional[int] = None,
                    slab_io: bool = True, resident: bool = False,
                    axis: int = 1) -> dict:
    """The cost ingredients of one launch (or one megakernel phase),
    itemized: ``predicted_seconds`` (flat configs), the schedule-graph
    edge weights (``segment_seconds``) and ``cost_breakdown`` all price
    through this one function.

    ``block`` pads the lines (None: no padding); ``tile`` is the lines a
    block holds (one constants read each; None: ``ops.kernel_tile``'s);
    ``slab_io``: the launch reads and writes its slab (a megakernel's
    segment does not: its scene crosses device memory at the entry, the
    exit and each turn, priced by the schedule); ``resident``: a resident
    megakernel's segment, whose long passes (``ops.long_geometry``) run
    over the slab in shared memory, each its stages' sweep and one turn
    of the slab through registers (``smem_seconds``), not through device
    memory; ``axis``: the launch's layout (a long op of one digit on the
    rows layout runs whole-line tiles, ``LongGeometry.whole_line``)."""
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
    slab = 2 * 2 * 4 * n * lines_total                 # x and y, re+im f32
    if slab_io:
        bytes_moved += slab
    geom = _long(n, factors, prec, axis)
    smem_bytes = 0
    if geom is not None and transforms:   # one more read and write a pass
        if resident:
            smem_bytes = 2 * geom.tile_passes(transforms == 2, True) * slab
        else:
            bytes_moved += (geom.passes(transforms == 2, True) - 1) * slab
    if filtered:
        bytes_moved += 2 * 4 * n                       # shared filter
    memory = bytes_moved / PEAK_HBM_BYTES + smem_bytes / SMEM_BYTES_PER_S

    return {
        "flops": _stage_flops(n, lines_total, factors, karatsuba,
                              transforms) + pointwise,
        "matmul_seconds": matmul,
        "vpu_seconds": vpu,
        "compute_seconds": compute,
        "bytes_moved": bytes_moved,
        "smem_bytes": smem_bytes,
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
# One cut, the kernels' own and the reference's where the slab fits: a
# batch_block-scene split f32 slab that fits one block's shared memory
# (16384 points: 128^2, 2 x 8192, 1 x 16384, at any split) runs
# mega_resident — a line past 4096 points or a three-factor split as the
# long passes on its slab — and every larger one mega_staged
# (ops.mega_residency).

mega_residency = ops.mega_residency


def mega_vmem_bytes(na: int, nr: int, batch_block: int = 1,
                    precision: Optional[str] = None,
                    filter_bytes: int = 0) -> int:
    """Shared memory of one mega_resident block: the ``batch_block``
    scenes' split f32 slab (8 B a point, at every precision) and, for
    bs16, an exponent a (scene, line) of the longer axis (4 B each). The
    DFT constants and the filters are read in place from device memory,
    so ``filter_bytes`` takes none; the long passes run in place on the
    slab."""
    del filter_bytes
    bb = batch_block or 1
    smem = 8 * bb * na * nr
    if resolve_precision(precision).block_scaled:
        smem += 4 * bb * max(na, nr)
    return smem


def _staged_phase_bytes(n: int, lines: int, axis: int, factors: tuple,
                        precision: Optional[str] = None) -> int:
    """Shared memory of one mega_staged phase on the matmul route (a long
    segment's largest pass)."""
    geom = _long(n, factors, precision, axis)
    if geom is not None:
        return geom.smem_bytes()
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
              filtered=shape.filtered, axis=shape.axis)
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
                           resident=residency == RESIDENT_VMEM,
                           **kw)["predicted_seconds"]


def collective_turn_bytes(na: int, nr: int, batch: int = 1,
                          devices: int = 1, elem_bytes: int = 4,
                          precision: Optional[str] = None) -> int:
    """Per-device all_to_all wire bytes of ONE corner turn: each device
    holds a split re/im 1/P slab and keeps 1/P of it, so (P-1)/P of the
    slab leaves it (``elem_bytes=2`` for a bf16 ``turn_dtype``).

    A block-scaled ``precision`` (bs16) adds the carried per-line
    exponent vector, one f32 a line of the turned axis, all-gathered
    beside the slab (``core.sar.distributed.lower_pipeline``); the turned
    axis is not known here, so the longer scene axis bounds it."""
    p = max(1, devices)
    slab = 2 * elem_bytes * na * nr * batch // p
    wire = slab * (devices - 1) // p
    if resolve_precision(precision).block_scaled:
        wire += 4 * max(na, nr) * batch * (devices - 1) // p
    return wire


def turn_seconds(problem: ScheduleProblem, *,
                 residency: Optional[str] = None,
                 buffer_depth: Optional[int] = None,
                 precision: Optional[str] = None) -> float:
    """The corner-turn edge weight between two segments on different
    axes.

    Local (``devices == 1``): free for a resident slab (its turn is a
    change of strides in shared memory), a device-memory write and read
    of the scene for the staged kernel.

    Sharded (``devices > 1``): every turn ends a launch, whatever the
    residency: each device writes its 1/P slab, sends (P-1)/P of it over
    NVLink (``collective_turn_bytes`` over ``PEAK_LINK_BYTES``) and reads
    the re-sharded slab back. No overlap credit: no kernel of the port
    prefetches (``buffer_depth`` is validated only)."""
    del buffer_depth
    if problem.devices > 1:
        p = problem.devices
        slab = 2 * 2 * 4 * problem.na * problem.nr * problem.batch // p
        wire = collective_turn_bytes(problem.na, problem.nr, problem.batch,
                                     p, precision=precision)
        return (slab * 2 / PEAK_HBM_BYTES
                + wire / PEAK_LINK_BYTES) * TURN_OVERLAP
    if residency != RESIDENT_STAGED:
        return 0.0
    traffic = 2 * 2 * 4 * problem.na * problem.nr * problem.batch
    return traffic / PEAK_HBM_BYTES * TURN_OVERLAP


def _mega_specs(schedule: Schedule, problem: ScheduleProblem) -> list:
    """The MegaSpecs a scheduled megakernel checks: each segment's split
    and Karatsuba in its record, the lane's residency (the cut's when
    deferred) and precision. A local problem is one launch; a sharded one
    is a launch per group of same-axis segments on one device's slab,
    ``(na/P, nr)`` for range groups and ``(na, nr/P)`` for azimuth ones,
    as ``core.sar.distributed.lower_pipeline`` splits it."""
    p = problem.devices
    groups: list = []
    for i, shape in enumerate(problem.segments):
        sc = schedule.segment(i)
        fs = sc.factors() or default_factorization(problem.seg_n(shape))
        seg = SegmentSpec(
            axis=shape.axis, fwd=shape.fwd, inv=shape.inv,
            filter_mode=FILTER_SHARED if shape.filtered else FILTER_NONE,
            n1=fs[0], n2=fs[1] if len(fs) > 1 else None,
            n3=fs[2] if len(fs) > 2 else None, karatsuba=sc.karatsuba)
        if groups and (p == 1 or groups[-1][0] == shape.axis):
            groups[-1][1].append(seg)
        else:
            groups.append((shape.axis, [seg]))
    precision = resolve_precision(schedule.precision).name
    specs = []
    for axis, segs in groups:
        na = problem.na // p if p > 1 and axis == 1 else problem.na
        nr = problem.nr // p if p > 1 and axis == 0 else problem.nr
        recs = [(g.axis, g.fwd, g.inv, g.filter_mode, g.n1, g.n2, g.n3,
                 g.karatsuba) for g in segs]
        residency = schedule.residency or mega_residency(
            na, nr, precision=precision,
            splits=ops.mega_splits(na, nr, recs))
        specs.append(MegaSpec(
            na=na, nr=nr, segments=tuple(segs), residency=residency,
            phase_block=schedule.phase_block or 8,
            buffer_depth=schedule.buffer_depth or 2, precision=precision))
    return specs


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
        return mega_vmem_bytes(problem.na // problem.devices, problem.nr,
                               1, schedule.precision, filter_bytes)
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
        for spec in _mega_specs(schedule, problem):
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
    """A megakernel's scene in and out of device memory once: one 1/P
    slab per device when sharded (the turns are priced in
    ``turn_seconds``)."""
    return (2 * 2 * 4 * problem.na * problem.nr * problem.batch
            / problem.devices / PEAK_HBM_BYTES)


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


def _default_mega_schedule(na: int, nr: int, devices: int = 1,
                           precision: Optional[str] = None,
                           filter_bytes: int = 0) -> Schedule:
    """The schedule the compiler picks unprompted: the residency cut on
    the (per-device) slab, default phase_block and buffer_depth."""
    res = mega_residency(na // devices if devices > 1 else na, nr,
                         precision=precision, filter_bytes=filter_bytes)
    return Schedule(segments=(SegmentConfig(),) * len(_MEGA_SEGMENTS_2D),
                    precision=precision, residency=res,
                    phase_block=8, buffer_depth=2)


def sharded_preferred(na: int, nr: int, batch: int = 1, devices: int = 1,
                      precision: Optional[str] = None,
                      filter_bytes: int = 0) -> bool:
    """Whether the model prefers the P-device sharded megakernel over ONE
    local launch for this scene: the service's big-scene routing
    predicate (``LocalBackend.execute_streamed``).

    Prices the canonical azimuth->range->azimuth megakernel both ways
    with :func:`schedule_seconds`: locally the turns are free (resident)
    or device-memory priced (staged); sharded they are all_to_all
    collectives, but every compute and slab term divides by P. A scene
    whose slab fits one block's shared memory never shards: the local
    resident megakernel serves it with no device-memory intermediates,
    and a collective would only add latency."""
    if devices <= 1 or na % devices or nr % devices:
        return False
    if mega_residency(na, nr, precision=precision,
                      filter_bytes=filter_bytes) == RESIDENT_VMEM:
        return False
    local = ScheduleProblem.mega_2d(na, nr, _MEGA_SEGMENTS_2D, batch=batch)
    shard = ScheduleProblem.mega_2d(na, nr, _MEGA_SEGMENTS_2D, batch=batch,
                                    devices=devices)
    local_s = schedule_seconds(
        _default_mega_schedule(na, nr, 1, precision, filter_bytes), local)
    shard_s = schedule_seconds(
        _default_mega_schedule(na, nr, devices, precision, filter_bytes),
        shard)
    return shard_s < local_s


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


def launch_counts(spec: SpectralSpec, batch: int, lines: int) -> dict:
    """The FLOPs and device-memory bytes ``_dispatch_terms`` prices one
    spectral launch of ``spec`` at (``batch`` x ``lines`` lines, padded
    already): what a dry run counts for a launch on meta tensors."""
    terms = _dispatch_terms(
        n=spec.n, lines=lines, batch=batch, factors=spec.factors(),
        karatsuba=spec.karatsuba, precision=spec.precision,
        transforms=int(spec.fwd) + int(spec.inv),
        filtered=spec.filter_mode != FILTER_NONE, block=None, axis=spec.axis)
    return {"flops": terms["flops"], "bytes": terms["bytes_moved"]}


def mega_launch_counts(spec: MegaSpec, batch: int) -> dict:
    """``launch_counts`` of one megakernel launch: each segment's terms
    without slab I/O, the scene read once and written once."""
    flops = 0.0
    nbytes = 2 * 2 * 4 * spec.na * spec.nr * batch
    for seg in spec.segments:
        n, lines = ((spec.na, spec.nr) if seg.axis == 0
                    else (spec.nr, spec.na))
        fs = tuple(f for f in (seg.n1, seg.n2, seg.n3) if f) or \
            default_factorization(n)
        terms = _dispatch_terms(
            n=n, lines=lines, batch=batch, factors=fs,
            karatsuba=bool(seg.karatsuba), precision=spec.precision,
            transforms=int(seg.fwd) + int(seg.inv),
            filtered=seg.filter_mode != FILTER_NONE, block=None,
            slab_io=False, resident=spec.residency == RESIDENT_VMEM,
            axis=seg.axis)
        flops += terms["flops"]
        nbytes += terms["bytes_moved"]
    return {"flops": flops, "bytes": nbytes}


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
    config (N > 2^21) ranks nothing."""
    feas = [c for c in configs if feasible(c, key, vmem_budget)]
    if feas:
        return sorted(feas, key=lambda c: predicted_seconds(c, key, **kw))
    feas = [c for c in configs if structurally_feasible(c, key)]
    return sorted(feas, key=lambda c: (vmem_bytes(c, key),
                                       predicted_seconds(c, key, **kw)))
