"""The tuning search space: typed keys and configs (the port's copy of
the JAX package's ``repro.tuning.space``, same names, types and schema).

:class:`TuneKey`
    WHAT a tuned config is for — problem shape (FFT length, batch
    bucket, line count, requested precision) plus WHERE it was measured
    (the torch device type and the device fingerprint,
    ``torch.cuda.get_device_name()``, or ``"cpu"`` when the caller asks
    for the CPU; with no device named, the card, and no card raises):
    the winning tile decomposition is device-specific, so a config tuned
    on one device kind must never be served to another. Batch is normalized to the
    serving batcher's power-of-two buckets at key construction (see
    :func:`bucket_batch`).

:class:`KernelConfig`
    HOW to run the launch — the tunable knobs of one fused spectral op
    (``block``, mixed-radix ``n1/n2/n3``, ``karatsuba``, ``precision``)
    plus the pipeline-level ``col_block`` and the megakernel knobs.
    Kernels consume the spectral subset via
    :meth:`KernelConfig.spectral_kwargs`; plans consume the whole record.

:class:`Schedule` generalizes a KernelConfig to one decision per segment
of a multi-segment launch (a megakernel's in-kernel segments, or a
plan's spectral steps in compile order).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.fft4step import (
    MAX_FACTOR,
    RESIDENT_STAGED,
    RESIDENT_VMEM,
    SpectralSpec,
    default_factorization,
    resolve_precision,
)

KIND_KERNEL = "kernel"       # one fused spectral dispatch (rows, fwd+inv)
KIND_PIPELINE = "pipeline"   # a whole compiled plan (service warm sweep)

SPECTRAL_KEYS = ("block", "n1", "n2", "n3", "karatsuba", "precision")
# megakernel (fused1) knobs: execution-residency mode of a cross-axis
# single-dispatch step, its staged-phase line block, and the staged DMA
# double-buffer depth
MEGA_KEYS = ("residency", "phase_block", "buffer_depth")
CONFIG_KEYS = SPECTRAL_KEYS + ("col_block",) + MEGA_KEYS
# the per-segment scheduling decisions a Schedule can vary where a flat
# KernelConfig holds one global value
SEGMENT_KEYS = ("n1", "n2", "n3", "karatsuba")


def bucket_batch(b: int) -> int:
    """The serving batcher's power-of-two batch bucket containing ``b``.

    Every distinct batch shape costs one jit trace, so the service pads
    partial micro-batches with zero scenes up to the next power of two
    (see service/backends.py). Tune keys use the same buckets: a config
    tuned for the padded shape is the config that actually runs."""
    return 1 << max(0, b - 1).bit_length()


def default_backend(device=None) -> str:
    """The torch device type a process tunes on: ``device``'s, or the
    card's (``resolve_device``: raises when there is none)."""
    return resolve_device(device).type


def device_fingerprint(device=None) -> str:
    """The device kind a process tunes on (``device``, or the card's:
    ``resolve_device`` raises when there is none):
    ``torch.cuda.get_device_name`` on a CUDA device, else the device type
    (``"cpu"``) — sanitized for use inside an encoded cache key."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return str(kind).strip().replace(" ", "-").replace("|", "-")


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """One slot in the tuning cache: problem shape + measurement device."""

    kind: str                        # KIND_KERNEL | KIND_PIPELINE
    backend: str                     # torch device type at tune time
    device: str                      # device fingerprint (device_kind)
    n: int                           # FFT length (kernel) / nr (pipeline)
    batch: int                       # power-of-two batch bucket
    lines: int                       # free-axis length (kernel: timing
                                     # proxy; pipeline: na)
    precision: Optional[str] = None  # requested policy (pipeline kind);
                                     # None for kernel keys — precision is
                                     # part of the searched config there
    variant: Optional[str] = None    # plan variant (pipeline kind)

    def __post_init__(self):
        if self.batch != bucket_batch(self.batch):
            raise ValueError(
                f"TuneKey.batch must be a power-of-two bucket, got "
                f"{self.batch} (use TuneKey.kernel()/pipeline() or "
                f"bucket_batch())")

    @classmethod
    def kernel(cls, n: int, batch: int = 1, lines: int = 16,
               backend: Optional[str] = None,
               device: Optional[str] = None) -> "TuneKey":
        """Key for one fused rows dispatch; batch normalizes to its
        power-of-two bucket so padded service batches hit the cache.
        ``backend`` None is the card's (raises without one); the
        fingerprint follows ``backend`` unless given."""
        backend = backend or default_backend()
        return cls(kind=KIND_KERNEL,
                   backend=backend,
                   device=device or device_fingerprint(backend),
                   n=int(n), batch=bucket_batch(int(batch)),
                   lines=int(lines))

    @classmethod
    def pipeline(cls, variant: str, na: int, nr: int, batch: int = 1,
                 precision: Optional[str] = None,
                 backend: Optional[str] = None,
                 device: Optional[str] = None) -> "TuneKey":
        """Key for a whole compiled plan on an (na, nr) scene geometry —
        the service's warm-time (block, col_block) sweep slot."""
        backend = backend or default_backend()
        return cls(kind=KIND_PIPELINE,
                   backend=backend,
                   device=device or device_fingerprint(backend),
                   n=int(nr), batch=bucket_batch(int(batch)),
                   lines=int(na), precision=precision, variant=variant)

    def encode(self) -> str:
        """Stable string form used as the JSON cache key."""
        return "|".join((
            self.kind, self.backend, self.device, f"n{self.n}",
            f"B{self.batch}", f"L{self.lines}",
            self.precision or "-", self.variant or "-",
        ))

    @classmethod
    def decode(cls, s: str) -> "TuneKey":
        parts = s.split("|")
        if len(parts) != 8:
            raise ValueError(f"malformed TuneKey string {s!r}")
        kind, backend, device, n, b, lines, prec, var = parts
        return cls(kind=kind, backend=backend, device=device,
                   n=int(n.lstrip("n")), batch=int(b.lstrip("B")),
                   lines=int(lines.lstrip("L")),
                   precision=None if prec == "-" else prec,
                   variant=None if var == "-" else var)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One candidate (or winning) kernel/pipeline configuration.

    ``None`` means "defer to the next layer's default" (library
    factorization, block 8 rows / 128 cols, f32). ``col_block`` belongs
    to the columns dispatch of a compiled plan — kernels never see it
    (:meth:`spectral_kwargs` excludes it); ``-1`` means "all lines" and
    is resolved against the scene by the consumer."""

    block: Optional[int] = None
    n1: Optional[int] = None
    n2: Optional[int] = None
    n3: Optional[int] = None
    karatsuba: Optional[bool] = None     # tri-state: None defers too
    precision: Optional[str] = None
    col_block: Optional[int] = None
    residency: Optional[str] = None      # megakernel mode: vmem | staged
    phase_block: Optional[int] = None    # staged-phase line block
    buffer_depth: Optional[int] = None   # staged DMA double-buffer depth

    def __post_init__(self):
        if self.precision is not None:
            resolve_precision(self.precision)   # raises on unknown policy
        for name in ("n1", "n2", "n3"):
            f = getattr(self, name)
            if f is not None and (f < 1 or f & (f - 1) or f > MAX_FACTOR):
                raise ValueError(
                    f"{name}={f} is not a power of two <= {MAX_FACTOR}")
        if self.residency not in (None, RESIDENT_VMEM, RESIDENT_STAGED):
            raise ValueError(
                f"residency={self.residency!r} is not one of "
                f"{(RESIDENT_VMEM, RESIDENT_STAGED)}")
        pb = self.phase_block
        if pb is not None and (pb < 1 or pb & (pb - 1)):
            raise ValueError(
                f"phase_block={pb} is not a power of two (staged phases "
                "strip power-of-two scene axes)")
        bd = self.buffer_depth
        if bd is not None and (not isinstance(bd, int) or bd < 1):
            raise ValueError(
                f"buffer_depth={bd!r} is not a positive integer")

    # -- views ---------------------------------------------------------------
    def spectral_kwargs(self) -> dict:
        """The kernel-facing subset as ``ops.spectral_op`` kwargs.
        ``None`` entries (karatsuba included — it is tri-state) are
        dropped so downstream defaults apply."""
        d = {k: getattr(self, k) for k in SPECTRAL_KEYS}
        return {k: v for k, v in d.items() if v is not None}

    def factors(self) -> Optional[tuple]:
        """The explicit factorization (n1, n2[, n3]), or None if deferred."""
        if self.n1 is None:
            return None
        fs = [self.n1]
        if self.n2 is not None:
            fs.append(self.n2)
        if self.n3 is not None:
            fs.append(self.n3)
        return tuple(fs)

    def apply(self, spec: SpectralSpec) -> SpectralSpec:
        """A SpectralSpec with this config's non-None knobs applied. The
        port's SpectralSpec has no ``block`` (a line-padding granule of
        ``ops.spectral_op``, which the kernels' tiles do not depend on),
        so it is left out."""
        updates = {k: v for k, v in self.spectral_kwargs().items()
                   if k != "block"}
        if self.factors() is not None:
            # an explicit factorization replaces the spec's wholesale:
            # mixing factors from two configs would break n = n1*n2[*n3]
            updates.setdefault("n2", None)
            updates.setdefault("n3", None)
        return dataclasses.replace(spec, **updates)

    def merge_overrides(self, overrides: dict) -> "KernelConfig":
        """This config with explicit per-compile overrides (e.g.
        ``compile_plan``'s ``fft_kw``) applied on top. An override that
        names ANY of n1/n2/n3 replaces the factorization wholesale —
        mixing factors from two configs would break n = n1*n2[*n3]."""
        d = self.to_dict()
        if any(k in overrides for k in ("n1", "n2", "n3")):
            for k in ("n1", "n2", "n3"):
                d[k] = overrides.get(k)
        for k in ("block", "karatsuba", "precision", "col_block") + MEGA_KEYS:
            if overrides.get(k) is not None:
                d[k] = overrides[k]
        return KernelConfig.from_dict(d)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in CONFIG_KEYS}

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        """Build from a dict, tolerating extra keys (legacy autotune cache
        entries carry ``seconds`` etc.)."""
        return cls(**{k: d[k] for k in CONFIG_KEYS if k in d})


# ---------------------------------------------------------------------------
# Schedule IR — per-segment decisions over a multi-segment dispatch
# ---------------------------------------------------------------------------
#
# A flat KernelConfig holds ONE global factorization/karatsuba for every
# transform segment of a dispatch. A Schedule is the generalized record:
# one SegmentConfig per segment (the per-segment edge choices of the
# schedule DAG — factorization and complex-product algorithm) plus the
# dispatch-global lane decisions (block, precision, residency,
# phase_block, buffer_depth). KernelConfig is the degenerate one-segment
# (or uniform) schedule: Schedule.from_config / Schedule.to_config
# convert losslessly in that case.

@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Per-segment scheduling decisions: the mixed-radix factorization of
    THIS segment's transform and its complex-product algorithm. ``None``
    defers to the next layer's default, exactly like KernelConfig."""

    n1: Optional[int] = None
    n2: Optional[int] = None
    n3: Optional[int] = None
    karatsuba: Optional[bool] = None     # tri-state, like KernelConfig

    def __post_init__(self):
        for name in ("n1", "n2", "n3"):
            f = getattr(self, name)
            if f is not None and (f < 1 or f & (f - 1) or f > MAX_FACTOR):
                raise ValueError(
                    f"{name}={f} is not a power of two <= {MAX_FACTOR}")

    def factors(self) -> Optional[tuple]:
        """The explicit factorization (n1, n2[, n3]), or None if deferred."""
        if self.n1 is None:
            return None
        fs = [self.n1]
        if self.n2 is not None:
            fs.append(self.n2)
        if self.n3 is not None:
            fs.append(self.n3)
        return tuple(fs)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in SEGMENT_KEYS}

    @classmethod
    def from_dict(cls, d: dict) -> "SegmentConfig":
        return cls(**{k: d[k] for k in SEGMENT_KEYS if k in d})


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One complete path through the schedule DAG: per-segment decisions
    (``segments``) plus the dispatch-global lane (block/precision/
    residency/phase_block/buffer_depth). Hashable and JSON-serializable —
    schedules persist in the schema-2 tuning cache and key the compiled-
    pipeline cache."""

    segments: tuple = ()                 # tuple[SegmentConfig, ...]
    block: Optional[int] = None
    col_block: Optional[int] = None
    precision: Optional[str] = None
    residency: Optional[str] = None      # megakernel mode: vmem | staged
    phase_block: Optional[int] = None    # staged-phase line block
    buffer_depth: Optional[int] = None   # staged DMA buffer depth

    def __post_init__(self):
        segs = tuple(
            s if isinstance(s, SegmentConfig) else SegmentConfig.from_dict(s)
            for s in self.segments)
        object.__setattr__(self, "segments", segs)
        # reuse KernelConfig's knob validation for the global lane
        KernelConfig(block=self.block, col_block=self.col_block,
                     precision=self.precision, residency=self.residency,
                     phase_block=self.phase_block,
                     buffer_depth=self.buffer_depth)

    def segment(self, i: int) -> SegmentConfig:
        """Segment ``i``'s decisions; a deferred (all-None) config past
        the end, so consumers never index-error on shorter schedules."""
        if 0 <= i < len(self.segments):
            return self.segments[i]
        return SegmentConfig()

    def uniform(self) -> bool:
        """Whether every segment carries identical decisions (the flat-
        KernelConfig-expressible subset of the schedule space)."""
        return len(set(self.segments)) <= 1

    # -- KernelConfig bridge -------------------------------------------------
    def to_config(self) -> KernelConfig:
        """The flat-config view: exact when the schedule is uniform (or
        empty); otherwise the per-segment fields drop to None — a
        non-uniform schedule is NOT expressible as a KernelConfig, which
        is the point of the IR."""
        d = dict(block=self.block, col_block=self.col_block,
                 precision=self.precision, residency=self.residency,
                 phase_block=self.phase_block,
                 buffer_depth=self.buffer_depth)
        if self.segments and self.uniform():
            d.update(self.segments[0].to_dict())
        return KernelConfig(**d)

    @classmethod
    def from_config(cls, config: KernelConfig,
                    n_segments: int = 1) -> "Schedule":
        """The degenerate schedule a flat KernelConfig denotes: the same
        per-segment decisions replicated across ``n_segments``."""
        seg = SegmentConfig(n1=config.n1, n2=config.n2, n3=config.n3,
                            karatsuba=config.karatsuba)
        return cls(segments=(seg,) * max(1, n_segments),
                   block=config.block, col_block=config.col_block,
                   precision=config.precision, residency=config.residency,
                   phase_block=config.phase_block,
                   buffer_depth=config.buffer_depth)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "segments": [s.to_dict() for s in self.segments],
            "block": self.block, "col_block": self.col_block,
            "precision": self.precision, "residency": self.residency,
            "phase_block": self.phase_block,
            "buffer_depth": self.buffer_depth,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        """Build from a dict, tolerating extra keys (cache entries carry
        ``seconds`` etc. alongside)."""
        keys = ("block", "col_block", "precision", "residency",
                "phase_block", "buffer_depth")
        kw = {k: d[k] for k in keys if k in d}
        return cls(segments=tuple(
            SegmentConfig.from_dict(s) for s in d.get("segments", ())), **kw)


@dataclasses.dataclass(frozen=True)
class SegmentShape:
    """The WORKLOAD of one schedule-DAG layer: which scene axis the
    segment transforms, in which directions, and whether a filter
    multiply rides along. The transform length and free-axis line count
    derive from the owning ScheduleProblem's scene geometry."""

    axis: int                            # 0 = columns, 1 = rows
    fwd: bool = False
    inv: bool = False
    filtered: bool = False

    def __post_init__(self):
        if self.axis not in (0, 1):
            raise ValueError(f"axis must be 0 or 1, got {self.axis}")


@dataclasses.dataclass(frozen=True)
class ScheduleProblem:
    """What the schedule-graph search optimizes over: an (na, nr) scene,
    a batch, and the ordered transform segments. ``mega=False`` is the
    single-dispatch rows problem the flat kernel tuner times (one
    segment, so the graph degenerates to the old product sweep);
    ``mega=True`` is a cross-axis megakernel whose segments may each pick
    their own factorization — the part of the space no flat KernelConfig
    can express."""

    na: int
    nr: int
    batch: int = 1
    segments: tuple = ()                 # tuple[SegmentShape, ...]
    mega: bool = False

    def __post_init__(self):
        segs = tuple(
            s if isinstance(s, SegmentShape) else SegmentShape(**s)
            for s in self.segments)
        object.__setattr__(self, "segments", segs)

    @classmethod
    def kernel(cls, n: int, batch: int = 1, lines: int = 16
               ) -> "ScheduleProblem":
        """The flat kernel tuner's workload: one fused fwd+inv filtered
        rows dispatch on a (batch, lines, n) slab."""
        return cls(na=int(lines), nr=int(n), batch=int(batch),
                   segments=(SegmentShape(axis=1, fwd=True, inv=True,
                                          filtered=True),), mega=False)

    @classmethod
    def mega_2d(cls, na: int, nr: int, segments, batch: int = 1
                ) -> "ScheduleProblem":
        """A cross-axis megakernel workload; ``segments`` is a sequence
        of SegmentShape (or kwargs dicts) in dispatch order."""
        return cls(na=int(na), nr=int(nr), batch=int(batch),
                   segments=tuple(segments), mega=True)

    def seg_n(self, shape: SegmentShape) -> int:
        """The transform length of a segment (the scene axis it strips)."""
        return self.nr if shape.axis == 1 else self.na

    def seg_lines(self, shape: SegmentShape) -> int:
        """The free-axis line count the segment's matmuls fold over."""
        return self.na if shape.axis == 1 else self.nr

    def turns(self) -> int:
        """Corner turns between consecutive segments on different axes."""
        return sum(1 for a, b in zip(self.segments, self.segments[1:])
                   if a.axis != b.axis)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

def factorizations(n: int) -> list[tuple[int, ...]]:
    """Candidate mixed-radix splits of ``n``: every sorted-descending
    2-factor decomposition into powers of two <= MAX_FACTOR, switching to
    3-factor decompositions past MAX_FACTOR**2 (the four-step recursion's
    3-stage regime). Invariants (tested): factors sorted descending, every
    factor <= MAX_FACTOR, product == n, non-empty up to MAX_FACTOR**3."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"FFT length must be a power of two >= 2, got {n}")
    p = n.bit_length() - 1
    out: list[tuple[int, ...]] = []
    if n <= MAX_FACTOR * MAX_FACTOR:
        for p1 in range((p + 1) // 2, p + 1):
            n1, n2 = 1 << p1, 1 << (p - p1)
            if n1 <= MAX_FACTOR and n1 >= n2 >= 1:
                out.append((n1, n2))
    else:
        for p1 in range(1, p - 1):
            for p2 in range(1, p - p1):
                fs = (1 << p1, 1 << p2, 1 << (p - p1 - p2))
                if all(f <= MAX_FACTOR for f in fs) and fs[0] >= fs[1] >= fs[2]:
                    out.append(fs)
    return out or [default_factorization(n)]


def candidates(n: int, blocks=(4, 8, 16),
               precisions=("f32",)) -> list[KernelConfig]:
    """The kernel search space for one FFT length: factorization x line
    block x karatsuba x precision, as typed configs."""
    out = []
    for fs, blk, kara, prec in itertools.product(
            factorizations(n), blocks, (False, True), precisions):
        out.append(KernelConfig(
            block=blk, karatsuba=kara, n1=fs[0], n2=fs[1],
            n3=fs[2] if len(fs) > 2 else None, precision=prec))
    return out
