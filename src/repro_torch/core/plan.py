"""SpectralPlan IR — the SAR focusing chain lifted into data.

A :class:`SpectralPlan` is a tuple of declarative :class:`Stage` records
(axis, fwd/inv, named filter refs, precision), and a small compiler turns
it into a :class:`Pipeline` of launches of the fused spectral op
(``kernels.ops.spectral_op``). RDA is only plans (core/sar/rda.py).

* **Fusion** — stages flatten to atoms (``fft`` / ``mul`` / ``ifft`` /
  ``transpose`` / custom) and regroup greedily under the kernel grammar
  ``fft? mul* ifft?`` on one transform axis; transposes and custom atoms
  are barriers. Fused ``mul`` atoms compose into one kernel filter:
  shared×shared → shared, shared×full → full, outer×outer → rank-(K₁+K₂)
  outer, shared×outer → shared_outer, full×outer → full.
  Under ``FUSE_MEGA`` (the megakernel grammar) an axis change opens a
  new in-kernel segment instead of a new launch: a cross-axis group
  compiles to ONE ``ops.mega_spectral_op`` launch.
* **Orientation** — a transpose step turns the scene (one launch of the
  tiled transpose kernel) and flips the orientation the compiler tracks:
  a spectral step inside a transposed section launches on the other
  physical axis, and its FULL filter is transposed with the data.
* **Filter caching** — host filter math is cached per
  ``(SceneConfig, params, filter_name)`` and composed payloads per
  ``(SceneConfig, plan, fuse, backend)``.
* **Backends** — ``"kernel"``: the fused op or the megakernel (the
  hand-written CUDA kernels on a CUDA device, their plain versions on the
  CPU); ``"torch"``: ``torch.fft`` ops per group (per segment of a
  cross-axis group), the unfused oracle.
* **Tuning** — each launch's knobs resolve in the reference's order:
  explicit compile args, then a :class:`~repro_torch.tuning.Schedule`,
  then the device-fingerprinted tuning cache (``tune="cached"``, a lookup,
  never a sweep), then library defaults; :func:`cached_pipeline` keeps
  compiled pipelines.

Plans serialize to/from JSON (``plan_to_json`` / ``plan_from_json``) in
the JAX package's format, so one plan definition drives both packages.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fft4step import (
    FILTER_FULL,
    FILTER_NONE,
    FILTER_OUTER,
    FILTER_SHARED,
    FILTER_SHARED_OUTER,
    resolve_precision,
)
from repro_torch.kernels.transpose import transpose
from repro_torch.tuning.search import cached_config
from repro_torch.tuning.space import KernelConfig, Schedule, SegmentConfig

BACKEND_KERNEL = "kernel"   # fused launches of the spectral op
BACKEND_TORCH = "torch"     # one torch.fft op per group (the unfused oracle)

# Fusion levels accepted by plan_dispatch_count's ``fuse``:
#   False      one dispatch per atom
#   True       per-axis fusion: fft? mul* ifft? on ONE transform axis
#   FUSE_MEGA  cross-axis fusion (the megakernel grammar)
FUSE_MEGA = "mega"


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (x.real.to(torch.float32).contiguous(),
            x.imag.to(torch.float32).contiguous())


def unsplit(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return torch.complex(xr.to(torch.float32), xi.to(torch.float32))


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One declarative pipeline stage.

    kind "spectral": ``[FFT if fwd] · filters · [IFFT if inv]`` along
    ``axis`` in scene coordinates (1 = range/rows, 0 = azimuth/columns).
    ``filters`` are registry names applied in order. ``precision``
    overrides the matmul-operand policy for this stage.
    kind "transpose": a global corner turn (fusion barrier). Other kinds
    dispatch to :func:`register_stage_impl` implementations with ``opts``
    (a tuple of (key, value) pairs, so the Stage stays hashable).
    """

    name: str
    kind: str = "spectral"
    axis: int = 1
    fwd: bool = False
    inv: bool = False
    filters: tuple[str, ...] = ()
    precision: Optional[str] = None
    opts: tuple[tuple[str, Any], ...] = ()

    def opt_dict(self) -> dict:
        return dict(self.opts)


@dataclasses.dataclass(frozen=True)
class SpectralPlan:
    """A named, hashable sequence of :class:`Stage` records plus static
    plan parameters that filter builders may read via ``params``."""

    name: str
    stages: tuple[Stage, ...]
    params: tuple[tuple[str, Any], ...] = ()

    def param_dict(self) -> dict:
        return dict(self.params)


# ---------------------------------------------------------------------------
# Serialization (the JAX package's format)
# ---------------------------------------------------------------------------

def plan_to_dict(plan: SpectralPlan) -> dict:
    return {
        "name": plan.name,
        "params": [list(p) for p in plan.params],
        "stages": [
            {
                "name": s.name, "kind": s.kind, "axis": s.axis,
                "fwd": s.fwd, "inv": s.inv, "filters": list(s.filters),
                "precision": s.precision, "opts": [list(o) for o in s.opts],
            }
            for s in plan.stages
        ],
    }


def plan_from_dict(d: dict) -> SpectralPlan:
    stages = tuple(
        Stage(
            name=s["name"], kind=s.get("kind", "spectral"),
            axis=s.get("axis", 1), fwd=s.get("fwd", False),
            inv=s.get("inv", False), filters=tuple(s.get("filters", ())),
            precision=s.get("precision"),
            opts=tuple((k, v) for k, v in s.get("opts", ())),
        )
        for s in d["stages"]
    )
    params = tuple((k, v) for k, v in d.get("params", ()))
    return SpectralPlan(name=d["name"], stages=stages, params=params)


def plan_to_json(plan: SpectralPlan, **kw) -> str:
    return json.dumps(plan_to_dict(plan), **kw)


def plan_from_json(s: str) -> SpectralPlan:
    return plan_from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Filter registry — named, lazily built host-side filters
# ---------------------------------------------------------------------------
#
# Builders run host-side (numpy) and return, per mode and in scene
# coordinates (n = transformed-axis length, lines = the other axis):
#   shared: complex vector (n,)
#   full:   complex matrix (na, nr)
#   outer:  (u (lines, K) float32, v (n, K) float32) — phase exp(i Σ u v)

@dataclasses.dataclass(frozen=True)
class FilterDef:
    name: str
    mode: str                      # FILTER_SHARED | FILTER_FULL | FILTER_OUTER
    build: Callable                # (cfg, params: dict) -> arrays


_FILTERS: dict[str, FilterDef] = {}


def register_filter(name: str, mode: str, build: Callable) -> None:
    if mode not in (FILTER_SHARED, FILTER_FULL, FILTER_OUTER):
        raise ValueError(f"unsupported filter mode {mode!r}")
    _FILTERS[name] = FilterDef(name, mode, build)


def filter_names() -> tuple[str, ...]:
    return tuple(sorted(_FILTERS))


# host-side filter-math cache: (cfg, params, name) -> built arrays, a
# bounded FIFO (full 2-D filters are scene-sized)
_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 64
_BUILD_STATS = {"hits": 0, "misses": 0}


def _fifo_put(cache: dict, key, value, limit: int) -> None:
    while len(cache) >= limit:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _built(name: str, cfg, params: tuple) -> tuple[str, Any]:
    fd = _FILTERS.get(name)
    if fd is None:
        raise KeyError(f"unknown filter {name!r}; registered: {filter_names()}")
    key = (cfg, params, name)
    if key in _BUILD_CACHE:
        _BUILD_STATS["hits"] += 1
    else:
        _BUILD_STATS["misses"] += 1
        _fifo_put(_BUILD_CACHE, key, fd.build(cfg, dict(params)),
                  _BUILD_CACHE_MAX)
    return fd.mode, _BUILD_CACHE[key]


def filter_cache_stats() -> dict:
    return dict(_BUILD_STATS)


def clear_filter_caches() -> None:
    _BUILD_CACHE.clear()
    _PAYLOAD_CACHE.clear()
    _BUILD_STATS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# Custom stage implementations (non-spectral kinds)
# ---------------------------------------------------------------------------
#
# impl(x, cfg, opts, lo, hi) -> x: complex in/out, batch-polymorphic.
# lo/hi select a row range for the streaming executor (None = whole scene);
# stream_axis names the scene axis the stage can be stripped along (None:
# the stage needs the whole scene and refuses to stream).

_STAGE_IMPLS: dict[str, tuple[Callable, Optional[int]]] = {}


def register_stage_impl(kind: str, impl: Callable,
                        stream_axis: Optional[int] = None) -> None:
    _STAGE_IMPLS[kind] = (impl, stream_axis)


# ---------------------------------------------------------------------------
# Stage flattening + fusion grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Atom:
    kind: str                 # "fft" | "ifft" | "mul" | "transpose" | custom
    axis: int                 # scene-coordinate transform/orientation axis
    filter: Optional[str]     # for "mul"
    stage: Stage


def _flatten(plan: SpectralPlan) -> list[_Atom]:
    atoms: list[_Atom] = []
    for s in plan.stages:
        if s.kind == "spectral":
            if s.fwd:
                atoms.append(_Atom("fft", s.axis, None, s))
            for f in s.filters:
                atoms.append(_Atom("mul", s.axis, f, s))
            if s.inv:
                atoms.append(_Atom("ifft", s.axis, None, s))
            if not (s.fwd or s.inv or s.filters):
                raise ValueError(f"empty spectral stage {s.name!r}")
        else:
            atoms.append(_Atom(s.kind, s.axis, None, s))
    return atoms


def _fusable(group: list[_Atom], atom: _Atom, mega: bool = False) -> bool:
    """May `atom` join `group` under the kernel grammar?

    Per-axis (mega=False): fft? mul* ifft? on ONE transform axis — an
    ifft closes the group, a forward fft only opens one, transposes and
    custom kinds never fuse. Cross-axis (mega=True): an axis change
    starts a fresh in-kernel segment; within the trailing same-axis
    segment the per-axis rules hold."""
    if atom.kind not in ("fft", "ifft", "mul"):
        return False
    if not group:
        return True
    if group[0].kind not in ("fft", "ifft", "mul"):
        return False
    if atom.axis != group[-1].axis:
        return mega                        # a turn: only the megakernel fuses
    seg = []
    for a in reversed(group):              # the trailing same-axis segment
        if a.axis != atom.axis:
            break
        seg.append(a)
    if any(a.kind == "ifft" for a in seg):
        return False                       # the inverse transform closes a segment
    if atom.kind == "fft":
        return False                       # a forward FFT only opens a segment
    return True


def _group_atoms(atoms: list[_Atom], fuse) -> list[list[_Atom]]:
    if not fuse:
        return [[a] for a in atoms]
    mega = fuse == FUSE_MEGA
    groups: list[list[_Atom]] = []
    cur: list[_Atom] = []
    for a in atoms:
        if cur and _fusable(cur, a, mega):
            cur.append(a)
        else:
            if cur:
                groups.append(cur)
            cur = [a]
    if cur:
        groups.append(cur)
    return groups


def _split_segments(group: list[_Atom]) -> list[list[_Atom]]:
    """A fused group as its per-axis segments (consecutive same-axis runs)."""
    segs: list[list[_Atom]] = []
    for a in group:
        if segs and segs[-1][0].axis == a.axis:
            segs[-1].append(a)
        else:
            segs.append([a])
    return segs


def plan_dispatch_count(plan: SpectralPlan, fuse=True) -> int:
    """Dispatches the compiler emits for ``plan`` (False / True /
    :data:`FUSE_MEGA`)."""
    return len(_group_atoms(_flatten(plan), fuse))


# ---------------------------------------------------------------------------
# Filter composition (host side, scene coordinates)
# ---------------------------------------------------------------------------

def _compose_group_filters(group: list[_Atom], cfg, params: tuple,
                           axis: int) -> tuple[str, tuple]:
    """Compose the group's mul atoms into ONE kernel filter payload.

    Returns (filter_mode, arrays) in scene coordinates:
      shared       -> (h complex (n,),)
      full         -> (h complex (na, nr),)
      outer        -> (u (lines, K) f32, v (n, K) f32)
      shared_outer -> (h (n,), u, v)
    """
    muls = [a for a in group if a.kind == "mul"]
    if not muls:
        return FILTER_NONE, ()
    shared = None
    full = None
    us, vs = [], []
    for a in muls:
        mode, arrs = _built(a.filter, cfg, params)
        if mode == FILTER_SHARED:
            h = np.asarray(arrs)
            shared = h if shared is None else shared * h
        elif mode == FILTER_FULL:
            h = np.asarray(arrs)
            full = h if full is None else full * h
        else:  # outer
            u, v = arrs
            us.append(np.asarray(u, np.float32).reshape(u.shape[0], -1))
            vs.append(np.asarray(v, np.float32).reshape(v.shape[0], -1))
    if full is not None:
        if shared is not None:
            full = full * (shared[None, :] if axis == 1 else shared[:, None])
        if us:
            u = np.concatenate(us, axis=1)
            v = np.concatenate(vs, axis=1)
            # fold the rank-K phase into the explicit filter (float32
            # phase, matching the kernel's on-chip synthesis)
            phase = (u @ v.T).astype(np.float32) if axis == 1 \
                else (v @ u.T).astype(np.float32)
            full = full * np.exp(1j * phase.astype(np.float64)).astype(
                full.dtype)
        return FILTER_FULL, (full,)
    if us:
        u = np.concatenate(us, axis=1)
        v = np.concatenate(vs, axis=1)
        if shared is not None:
            return FILTER_SHARED_OUTER, (shared, u, v)
        return FILTER_OUTER, (u, v)
    return FILTER_SHARED, (shared,)


# composed per-dispatch payload cache: (cfg, plan, fuse, backend) -> payloads
_PAYLOAD_CACHE: dict = {}
_PAYLOAD_CACHE_MAX = 64

# payload marker for a cross-axis (megakernel) group: the arrays slot
# holds one (axis, mode, arrays) record per in-kernel segment
MEGA = "mega"


def _group_payloads(plan: SpectralPlan, cfg, fuse, backend: str) -> tuple:
    key = (cfg, plan, fuse, backend)
    if key not in _PAYLOAD_CACHE:
        groups = _group_atoms(_flatten(plan), fuse)
        payloads = []
        for g in groups:
            if g[0].kind not in ("fft", "ifft", "mul"):
                payloads.append((FILTER_NONE, ()))
                continue
            segs = _split_segments(g)
            if len(segs) == 1:
                payloads.append(
                    _compose_group_filters(g, cfg, plan.params, g[0].axis))
            else:
                payloads.append((MEGA, tuple(
                    (s[0].axis,
                     *_compose_group_filters(s, cfg, plan.params, s[0].axis))
                    for s in segs)))
        _fifo_put(_PAYLOAD_CACHE, key, (groups, payloads),
                  _PAYLOAD_CACHE_MAX)
    return _PAYLOAD_CACHE[key]


# ---------------------------------------------------------------------------
# Compiled pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Step:
    """One compiled launch (or one oracle op in the torch backend).

    Besides ``fn``, a spectral step keeps the record of the launch it
    performs — ``phys_axis``, ``filter_mode``, ``filter_kw`` (device
    filter tensors) and ``kernel_kw`` (``ops.spectral_op`` keywords) — so
    it can be replayed through another implementation of the op, e.g.
    ``ops.spectral_op_plain`` on the card. A transpose step
    (``kind="transpose"``) turns the scene's last two axes. A mega step
    (``kind="mega"``)
    keeps ``kernel_kw`` (``ops.mega_spectral_op`` keywords) and
    ``seg_filter_args``, one tuple of device filter tensors per segment,
    whose concatenation is the launch's ``filter_args``.

    ``stream_axis`` is the scene axis the step's launch may be cut along
    into strips (its free, line axis) and ``strip_fn(xs, lo, hi)`` runs the
    step on the strip ``lo:hi`` of that axis, with its line-indexed filter
    payloads sliced to it (``Pipeline.run_streamed``); both are None for a
    step that needs the whole scene (a transpose, a mega step).
    """

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    dispatches: int
    hbm_roundtrips: int
    fused: bool
    kind: str = "spectral"                # "spectral" | custom
    phys_axis: Optional[int] = None       # physical transform axis
    filter_mode: str = FILTER_NONE        # composed kernel filter mode
    filter_kw: Optional[dict] = None      # device filter payloads
    kernel_kw: Optional[dict] = None      # ops.(mega_)spectral_op keywords
    seg_filter_args: Optional[tuple] = None   # mega: per-segment payloads
    stream_axis: Optional[int] = None     # scene axis strips cut along
    strip_fn: Optional[Callable] = None   # (xs, lo, hi) -> ys


@dataclasses.dataclass
class Pipeline:
    """A compiled plan: a named sequence of launch steps on one device,
    holding the device filter payloads for one ``(SceneConfig, plan)``."""

    name: str
    cfg: Any
    steps: list[Step]
    device: torch.device
    plan: Optional[SpectralPlan] = None

    @property
    def dispatches(self) -> int:
        return sum(s.dispatches for s in self.steps)

    @property
    def hbm_roundtrips(self) -> int:
        return sum(s.hbm_roundtrips for s in self.steps)

    def run(self, raw) -> torch.Tensor:
        """Execute the steps on one scene ``(na, nr)`` or a batch
        ``(B, na, nr)`` sharing the SceneConfig, complex64 in and out.
        ``raw`` (a tensor or numpy array) is moved to the pipeline's
        device. A batch runs each step as ONE launch over all scenes; each
        kernel step splits re/im before its launch and unsplits after."""
        x = torch.as_tensor(raw).to(self.device, torch.complex64)
        for s in self.steps:
            x = s.fn(x)
        return x

    def jitted(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The callable a caller runs batches through (the focusing
        service's warm path). The JAX package jit-compiles the step
        sequence here; the port's steps are already eager launches of the
        hand-written kernels, so this is :meth:`run` itself — no
        ``torch.compile``, which would put a compiled plain version in
        place of the kernels."""
        return self.run

    def lower_sharded(self, mesh=None, axes=("data",), **kw):
        """Lower this compiled pipeline onto a device mesh: every spectral
        step runs on slabs sharded along its free (line) axis, with an
        all-to-all corner turn wherever consecutive steps transform
        different axes. A mega step is split at its in-kernel turn
        boundaries into per-device segment groups, one megakernel launch
        per device per group, the turns between groups becoming the
        collectives. Transpose/custom stages do not lower. ``mesh=None``
        is every visible card (``distributed.make_sar_mesh``); see
        :func:`repro_torch.core.sar.distributed.lower_pipeline` (``kw``:
        ``turn_dtype``, ``residency``). Returns ``fn(raw) -> image``."""
        from repro_torch.core.sar import distributed
        if mesh is None:
            mesh = distributed.make_sar_mesh(axes)
        return distributed.lower_pipeline(self, mesh, axes=axes, **kw)

    def run_streamed(self, raw, strips: int = 4,
                     inflight: int = 2) -> np.ndarray:
        """Execute over host memory in ``strips`` tiles per step.

        Each launch runs strip by strip along its free (line) axis, with
        the line-indexed filter payloads sliced to the strip, so a scene
        that does not fit the device flows through the same compiled
        steps; between steps the scene lives on the host. On a CUDA device
        every strip is staged through pinned host memory: its
        host-to-device copy is issued ``non_blocking`` on a copy stream and
        ordered before the strip's launch by an event, so strip k+1's copy
        overlaps strip k's kernels; at most ``inflight`` strips are
        un-synchronised before the oldest is waited for, and each output
        strip comes back through a pinned buffer into a pinned host array
        (a fresh pageable one takes its first-touch page faults inside
        every step). On the CPU the strips
        run in turn. The image equals :meth:`run`'s bit for bit (every
        kernel treats its lines independently). ``raw`` is one ``(na, nr)``
        scene; returns the complex64 image as a numpy array."""
        x = torch.as_tensor(raw).to("cpu", torch.complex64)
        if x.ndim != 2:
            raise ValueError("run_streamed expects one (na, nr) scene")
        for step in self.steps:
            if step.stream_axis is None or step.strip_fn is None:
                raise ValueError(
                    f"step {step.name!r} does not support streaming "
                    "(global transposes need the whole scene; cross-axis "
                    "megakernel steps have no single free axis to strip "
                    "— use a per-axis variant like fused3)")
        cuda = self.device.type == "cuda"
        for step in self.steps:
            n = x.shape[step.stream_axis]
            sizes = [n // strips + (1 if i < n % strips else 0)
                     for i in range(strips)]
            bounds = []
            lo = 0
            for size in sizes:
                if size:
                    bounds.append((lo, lo + size))
                    lo += size
            if cuda:
                x = _stream_step_cuda(step, x, bounds, max(1, inflight),
                                      self.device)
            else:
                x = _stream_step_cpu(step, x, bounds)
        return x.numpy()


def _strip(axis: int, lo: int, hi: int) -> tuple:
    return ((slice(lo, hi), slice(None)) if axis == 0
            else (slice(None), slice(lo, hi)))


def _stream_step_cpu(step: Step, x, bounds):
    out = torch.empty_like(x)
    for lo, hi in bounds:
        sl = _strip(step.stream_axis, lo, hi)
        out[sl] = step.strip_fn(x[sl].contiguous(), lo, hi)
    return out


def _stream_step_cuda(step: Step, x, bounds, inflight, device):
    """One step over the host scene ``x``, strip by strip through pinned
    staging buffers into a pinned output: the copy in on a copy stream,
    the launch and the copy back on the current (compute) stream,
    ``inflight`` strips in flight at most."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    compute = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device=device)
    pending: deque = deque()

    def retire():
        sl, back, done = pending.popleft()
        done.synchronize()
        out[sl] = back

    for lo, hi in bounds:
        sl = _strip(step.stream_axis, lo, hi)
        stage = torch.empty(x[sl].shape, dtype=x.dtype, pin_memory=True)
        stage.copy_(x[sl])
        with torch.cuda.stream(copy):
            xs = stage.to(device, non_blocking=True)
            ready = copy.record_event()
        compute.wait_event(ready)
        xs.record_stream(compute)       # made on the copy stream
        ys = step.strip_fn(xs, lo, hi)
        back = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
        back.copy_(ys, non_blocking=True)
        pending.append((sl, back, compute.record_event()))
        while len(pending) >= inflight:
            retire()
    while pending:
        retire()
    return out


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

def _payload_to_device(mode: str, arrays: tuple, device,
                       transposed: bool = False) -> dict:
    """Scene-coordinate payload -> ``ops.spectral_op`` filter kwargs in
    the physical orientation (a FULL filter transposes with the data;
    shared vectors and outer u/v are orientation-invariant given the
    physical axis)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if mode == FILTER_NONE:
        return {}
    if mode in (FILTER_SHARED, FILTER_FULL):
        h = arrays[0]
        if mode == FILTER_FULL and transposed:
            h = h.T
        return {"hr": t(h.real.astype(np.float32)),
                "hi": t(h.imag.astype(np.float32))}
    if mode == FILTER_OUTER:
        u, v = arrays
        return {"u": t(u), "v": t(v)}
    h, u, v = arrays
    return {"hr": t(h.real.astype(np.float32)),
            "hi": t(h.imag.astype(np.float32)),
            "u": t(u), "v": t(v)}


def _torch_apply(x, fwd, inv, mode, fk, phys_axis):
    """The unfused oracle: the same math as one launch, in torch.fft ops.
    The result is made contiguous: a column transform returns a strided
    tensor, and torch.fft's bits depend on its input's strides, so every
    op takes the same layout whether it sees the scene or a strip of it
    (``Pipeline.run_streamed`` == ``run`` bit for bit)."""
    ax = -1 if phys_axis == 1 else -2
    if fwd:
        x = torch.fft.fft(x, dim=ax)
    if mode in (FILTER_SHARED, FILTER_FULL, FILTER_SHARED_OUTER):
        h = unsplit(fk["hr"], fk["hi"])
        if h.ndim == 1:
            h = h[None, :] if phys_axis == 1 else h[:, None]
        x = x * h
    if mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        u = fk["u"].reshape(fk["u"].shape[0], -1)
        v = fk["v"].reshape(fk["v"].shape[0], -1)
        phase = torch.einsum("lk,sk->ls", u, v)
        if phys_axis == 0:
            phase = phase.T
        x = x * torch.polar(torch.ones_like(phase), phase)
    if inv:
        x = torch.fft.ifft(x, dim=ax)
    return x.contiguous()


def _tuned_config(n: int, batch: int, device) -> KernelConfig:
    """Best-known kernel config for (n, batch) on ``device`` from the
    repro_torch.tuning cache (device-fingerprinted; batch normalized to
    its serving bucket). Never triggers a sweep — compile time is
    lookup-only; an empty KernelConfig (all defaults) on a miss."""
    return cached_config(n, batch, device=device) or KernelConfig()


def _schedule_segments(opts, count: int) -> tuple:
    """Consume ``count`` per-segment configs from the compile-wide
    schedule cursor. Spectral steps take one, a mega-fused group one per
    in-kernel segment, so a Schedule's segments map onto the plan's
    spectral segments in compile order. Empty configs when compiling
    without a schedule; a schedule shorter than the plan pads with empty
    configs too (``Schedule.segment`` past-the-end behaviour)."""
    sched = opts["schedule"]
    if sched is None:
        return (SegmentConfig(),) * count
    lo = opts["_seg_cursor"][0]
    opts["_seg_cursor"][0] = lo + count
    return tuple(sched.segment(lo + i) for i in range(count))


def _schedule_globals(tuned: KernelConfig, opts) -> KernelConfig:
    """The schedule's dispatch-global knobs applied over the tuned-cache
    config. Runs BEFORE the explicit fft_kw merge, so the resolution
    order stays: explicit compile args > schedule > tuned cache >
    library defaults."""
    sched = opts["schedule"]
    if sched is None:
        return tuned
    knobs = dict(block=sched.block, col_block=sched.col_block,
                 precision=sched.precision, residency=sched.residency,
                 phase_block=sched.phase_block,
                 buffer_depth=sched.buffer_depth)
    return tuned.merge_overrides(
        {k: v for k, v in knobs.items() if v is not None})


def _base_config(n: int, backend: str, opts) -> KernelConfig:
    """A launch's config before its segment's decisions: the tuned cache
    entry for (n, batch) on the pipeline's device (kernel backend,
    ``tune="cached"``), then the schedule's global knobs over it."""
    tuned = _tuned_config(n, opts["batch"], opts["device"]) if (
        backend == BACKEND_KERNEL and opts["tune"] != "off") else \
        KernelConfig()
    return _schedule_globals(tuned, opts)


def _slice_filter_kwargs(kw: dict, mode: str, phys_axis: int, lo: int,
                         hi: int) -> dict:
    """Slice the line-indexed filter payloads to a [lo, hi) line strip
    (a FULL filter's lines are its rows on a rows launch, its columns on a
    columns launch; the outer phase's u is (lines, K))."""
    out = dict(kw)
    if mode == FILTER_FULL:
        for k in ("hr", "hi"):
            out[k] = kw[k][lo:hi] if phys_axis == 1 else kw[k][:, lo:hi]
    if mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        out["u"] = kw["u"][lo:hi]
    return out


def _make_spectral_step(group, mode, arrays, *, cfg, transposed, backend,
                        opts) -> Step:
    axis = group[0].axis                       # logical (scene) axis
    phys_axis = (1 - axis) if transposed else axis
    fwd = any(a.kind == "fft" for a in group)
    inv = any(a.kind == "ifft" for a in group)
    n = cfg.nr if axis == 1 else cfg.na
    name = group[0].stage.name

    # per-launch kernel config: explicit compile args > stage precision >
    # schedule > tuned cache entry > library defaults
    tuned = _base_config(n, backend, opts)
    seg = _schedule_segments(opts, 1)[0]
    if seg.n1 is not None:
        tuned = tuned.merge_overrides(dict(n1=seg.n1, n2=seg.n2, n3=seg.n3))
    if seg.karatsuba is not None:
        tuned = tuned.merge_overrides(dict(karatsuba=seg.karatsuba))
    fkw = opts["fft_kw"] if axis == 1 else None
    if fkw:
        tuned = tuned.merge_overrides(fkw)
    if phys_axis == 1:
        block = opts["block"] or tuned.block or 8
    else:
        block = opts["col_block"] or 128
    stage_prec = next((a.stage.precision for a in group
                       if a.stage.precision is not None), None)
    precision = resolve_precision(
        opts["precision"] or stage_prec or tuned.precision).name
    kernel_kw = dict(axis=phys_axis, fwd=fwd, inv=inv, filter_mode=mode,
                     block=block, fft_impl=opts["fft_impl"],
                     precision=precision, n1=tuned.n1, n2=tuned.n2,
                     n3=tuned.n3, karatsuba=bool(tuned.karatsuba))
    filter_kw = _payload_to_device(mode, arrays, opts["device"], transposed)

    if backend == BACKEND_KERNEL:
        def fn(x, _fk=filter_kw):
            xr, xi = split(x)
            yr, yi = ops.spectral_op(xr, xi, **_fk, **kernel_kw)
            return unsplit(yr, yi)
    else:
        def fn(x, _fk=filter_kw):
            return _torch_apply(x, fwd, inv, mode, _fk, phys_axis)

    # streaming: strips run along the physical line axis; the scene must be
    # in its natural orientation for host strips to be meaningful
    stream_axis = None
    strip_fn = None
    if not transposed:
        stream_axis = 0 if phys_axis == 1 else 1

        def strip_fn(xs, lo, hi, _fk=filter_kw):
            fk = _slice_filter_kwargs(_fk, mode, phys_axis, lo, hi)
            if backend == BACKEND_KERNEL:
                xr, xi = split(xs)
                return unsplit(*ops.spectral_op(xr, xi, **fk, **kernel_kw))
            return _torch_apply(xs, fwd, inv, mode, fk, phys_axis)

    fused = backend == BACKEND_KERNEL and len(group) > 1
    return Step(name, fn, 1, 1, fused, kind="spectral", phys_axis=phys_axis,
                filter_mode=mode, filter_kw=filter_kw, kernel_kw=kernel_kw,
                stream_axis=stream_axis, strip_fn=strip_fn)


def _make_mega_step(group, seg_payloads, *, cfg, backend, opts) -> Step:
    """One cross-axis fused group -> ONE megakernel launch (or the
    per-segment torch.fft oracle chain in the torch backend).

    Residency: the explicit compile option, else the tuned cache entry or
    schedule, else the shared-memory cut ``ops.mega_residency`` (a slab of
    16384 points or fewer resident — 128^2, 2 x 8192, at any split —
    larger scenes staged). A schedule's per-segment split and Karatsuba
    ride in 8-field segment records."""
    segs = _split_segments(group)
    name = "+".join(dict.fromkeys(a.stage.name for a in group))
    segments = []
    seg_fk = []           # per-segment filter kwargs (the torch oracle's)
    seg_args = []         # the same tensors in ops.mega_spectral_op order
    for atoms, (axis, mode, arrays) in zip(segs, seg_payloads):
        fwd = any(a.kind == "fft" for a in atoms)
        inv = any(a.kind == "ifft" for a in atoms)
        segments.append((axis, fwd, inv, mode))
        fk = _payload_to_device(mode, arrays, opts["device"])
        seg_fk.append((axis, fwd, inv, mode, fk))
        seg_args.append(tuple(fk[k] for k in ("hr", "hi", "u", "v")
                              if k in fk))
    segments = tuple(segments)
    filter_args = [t for args in seg_args for t in args]

    tuned = _base_config(cfg.nr, backend, opts)
    seg_cfgs = _schedule_segments(opts, len(segs))
    if opts["fft_kw"]:
        tuned = tuned.merge_overrides(opts["fft_kw"])
    stage_prec = next((a.stage.precision for a in group
                       if a.stage.precision is not None), None)
    precision = resolve_precision(
        opts["precision"] or stage_prec or tuned.precision).name
    batch_block = opts["batch_block"]
    # per-segment schedule decisions ride as extended 8-field segment
    # records (axis, fwd, inv, mode, n1, n2, n3, karatsuba) — the kernel
    # resolves each against the launch-global factorization/karatsuba
    if any(sc != SegmentConfig() for sc in seg_cfgs):
        segments = tuple(rec + (sc.n1, sc.n2, sc.n3, sc.karatsuba)
                         for rec, sc in zip(segments, seg_cfgs))
    # the cut is handed each segment's resolved split; mega_resident runs
    # a line past one block or three factors on its slab, so the slab's
    # fit alone decides
    residency = opts["residency"] or tuned.residency or ops.mega_residency(
        cfg.na, cfg.nr, batch_block or 1, precision,
        splits=ops.mega_splits(cfg.na, cfg.nr, segments, n1=tuned.n1,
                               n2=tuned.n2, n3=tuned.n3,
                               fft_impl=opts["fft_impl"]))
    kernel_kw = dict(
        segments=segments, residency=residency, batch_block=batch_block,
        phase_block=opts["phase_block"] or tuned.phase_block or 8,
        buffer_depth=opts["buffer_depth"] or tuned.buffer_depth or 2,
        fft_impl=opts["fft_impl"], precision=precision, n1=tuned.n1,
        n2=tuned.n2, n3=tuned.n3, karatsuba=bool(tuned.karatsuba))

    if backend == BACKEND_KERNEL:
        def fn(x, _fa=tuple(filter_args)):
            xr, xi = split(x)
            yr, yi = ops.mega_spectral_op(xr, xi, *_fa, **kernel_kw)
            return unsplit(yr, yi)
    else:
        def fn(x):
            for axis, fwd, inv, mode, fk in seg_fk:
                x = _torch_apply(x, fwd, inv, mode, fk, axis)
            return x

    return Step(name, fn, 1, 1, backend == BACKEND_KERNEL, kind="mega",
                filter_mode=MEGA, kernel_kw=kernel_kw,
                seg_filter_args=tuple(seg_args))


def _make_transpose_step(stage: Stage, backend: str) -> Step:
    """One corner turn of the complex64 scene: in the kernel backend ONE
    launch of the tiled transpose on 8-byte elements (the reference turns
    the re and im planes in two calls; a transpose is exact, so the
    numbers are the same), in the torch backend a swap of the last two
    axes."""
    if backend == BACKEND_KERNEL:
        fn = transpose
    else:
        def fn(x):
            return x.transpose(-1, -2).contiguous()
    return Step(stage.name, fn, 1, 1, False, kind="transpose")


def _make_custom_step(stage: Stage, cfg) -> Step:
    if stage.kind not in _STAGE_IMPLS:
        raise KeyError(f"no implementation registered for stage kind "
                       f"{stage.kind!r}")
    impl, stream_axis = _STAGE_IMPLS[stage.kind]
    opts = stage.opt_dict()

    def fn(x):
        return impl(x, cfg, opts, None, None)

    strip_fn = None
    if stream_axis is not None:
        def strip_fn(xs, lo, hi):
            return impl(xs, cfg, opts, lo, hi)
    return Step(stage.name, fn, 1, 1, False, kind=stage.kind,
                stream_axis=stream_axis, strip_fn=strip_fn)


def compile_plan(
    plan: SpectralPlan,
    cfg,
    *,
    backend: str = BACKEND_KERNEL,
    fuse=True,
    device=None,
    block: Optional[int] = None,
    col_block: Optional[int] = None,
    fft_impl: str = "matmul",
    precision: Optional[str] = None,
    residency: Optional[str] = None,
    phase_block: Optional[int] = None,
    buffer_depth: Optional[int] = None,
    batch_block: Optional[int] = None,
    batch: int = 1,
    tune: str = "cached",
    fft_kw: Optional[dict] = None,
    schedule: Optional[Schedule] = None,
) -> Pipeline:
    """Compile a plan against a concrete scene into a :class:`Pipeline`.

    cfg is a :class:`~repro_torch.core.sar.SceneConfig`; the pipeline
    takes one ``(cfg.na, cfg.nr)`` complex64 scene or any batch
    ``(B, na, nr)`` sharing it.

    backend: 'kernel' (fused launches) or 'torch' (torch.fft oracle ops).
    fuse: merge adjacent compatible atoms into single launches. ``True``
      fuses per transform axis; :data:`FUSE_MEGA` also fuses ACROSS axis
      changes into single-launch megakernel steps (the fused1 family).
    device: where the pipeline runs; None is the CUDA card (raises
      without one), "cpu" runs the plain version.
    block/col_block: line padding granule of rows/columns launches.
    fft_impl: 'matmul' (the four-step DFT-matrix stages) or 'stockham'
      (the self-sorting radix-4/radix-2 Stockham passes, the paper's
      scalar baseline), in every spectral and mega step.
    precision: matmul-operand policy for every spectral stage (over each
      ``Stage.precision``); the CUDA kernels take all four on the
      Stockham route and f32 alone on the matmul route.
    residency: megakernel mode of mega steps — 'vmem' (on Hopper: the
      whole scene in one block's shared memory) or 'staged' (phases
      through device memory); None picks by ``ops.mega_residency``.
    phase_block / buffer_depth / batch_block: the megakernel's staged line
      granule (default 8), prefetch depth (default 2) and resident scenes
      per slab (default 1), as the reference takes them.
    batch: scene-batch size the tuned configs are *looked up* for
      (normalized to the serving power-of-two bucket); it does not
      restrict the shapes the pipeline accepts.
    tune: 'cached' pulls per-launch kernel configs (split, Karatsuba,
      precision, block; residency and staged knobs for mega steps) from
      the repro_torch.tuning cache under this device's fingerprint; 'off'
      uses library defaults. With an empty cache both compile the same.
    fft_kw: explicit config for range-axis (axis=1) launches — e.g. a
      just-measured split from a repro_torch.tuning search.
    schedule: a :class:`repro_torch.tuning.Schedule` (a schedule search
      winner) to compile through. Its global knobs override the tuned
      cache entry, and its per-segment split/Karatsuba decisions map onto
      the plan's spectral segments in compile order — a mega step takes
      one per in-kernel segment (8-field segment records), every other
      spectral step one. Explicit per-knob compile args (block,
      precision, fft_kw, residency, ...) still win over the schedule.
    """
    if backend not in (BACKEND_KERNEL, BACKEND_TORCH):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    groups, payloads = _group_payloads(plan, cfg, fuse, backend)
    if tune not in ("cached", "off"):
        raise ValueError(f"tune must be 'cached' or 'off', got {tune!r}")
    opts = dict(block=block, col_block=col_block, fft_impl=fft_impl,
                precision=precision, device=dev, residency=residency,
                phase_block=phase_block, buffer_depth=buffer_depth,
                batch_block=batch_block, batch=batch, tune=tune,
                fft_kw=fft_kw or {}, schedule=schedule, _seg_cursor=[0])
    steps: list[Step] = []
    transposed = False
    for group, (mode, arrays) in zip(groups, payloads):
        kind = group[0].kind
        if mode == MEGA:
            if transposed:
                raise ValueError(
                    f"mega step {group[0].stage.name!r} inside a "
                    "transposed section is not supported")
            steps.append(_make_mega_step(
                group, arrays, cfg=cfg, backend=backend, opts=opts))
        elif kind in ("fft", "ifft", "mul"):
            steps.append(_make_spectral_step(
                group, mode, arrays, cfg=cfg, transposed=transposed,
                backend=backend, opts=opts))
        elif kind == "transpose":
            steps.append(_make_transpose_step(group[0].stage, backend))
            transposed = not transposed
        else:
            if transposed:
                raise ValueError(
                    f"custom stage {group[0].stage.name!r} inside a "
                    "transposed section is not supported")
            steps.append(_make_custom_step(group[0].stage, cfg))
    if transposed:
        raise ValueError(f"plan {plan.name!r} ends in transposed orientation")
    return Pipeline(plan.name, cfg, steps, dev, plan)


# ---------------------------------------------------------------------------
# Variant registry — named plans + their compile defaults
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Variant:
    """A registered pipeline variant: a plan factory, how to compile it,
    and its documented dispatch count (the fusion-legality invariant)."""

    name: str
    plan_fn: Callable[..., SpectralPlan]
    compile_defaults: tuple[tuple[str, Any], ...] = ()
    plan_kw: tuple[str, ...] = ()       # build kwargs routed to plan_fn
    dispatches: int = 0                 # documented compiled dispatch count


_VARIANTS: dict[str, Variant] = {}


def register_variant(name: str, plan_fn, *, compile_defaults=(),
                     plan_kw=(), dispatches=0) -> None:
    _VARIANTS[name] = Variant(name, plan_fn, tuple(compile_defaults),
                              tuple(plan_kw), dispatches)


def get_variant(name: str) -> Variant:
    if name not in _VARIANTS:
        raise KeyError(f"unknown pipeline variant {name!r}; "
                       f"registered: {sorted(_VARIANTS)}")
    return _VARIANTS[name]


def variant_names() -> tuple[str, ...]:
    return tuple(sorted(_VARIANTS))


def build_variant(cfg, name: str, **kw) -> Pipeline:
    """Build + compile a registered variant. Plan-level kwargs (the
    variant's plan_kw) go to the plan factory; the rest override the
    variant's compile defaults and go to compile_plan."""
    var = get_variant(name)
    plan_args = {k: kw.pop(k) for k in list(kw) if k in var.plan_kw}
    compile_args = dict(var.compile_defaults)
    compile_args.update(kw)
    return compile_plan(var.plan_fn(**plan_args), cfg, **compile_args)


# ---------------------------------------------------------------------------
# Compiled-pipeline cache
# ---------------------------------------------------------------------------
#
# compile_plan is cheap-ish (payloads are cached) but not free: one warm
# Pipeline per (scene geometry, variant, compile options) keeps its device
# filter payloads and tuning lookups. Bounded FIFO like the filter caches:
# pipelines hold scene-sized device payloads.

_PIPELINE_CACHE: dict = {}
_PIPELINE_CACHE_MAX = 32


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def cached_pipeline(cfg, variant: str, **kw) -> Pipeline:
    """``build_variant`` behind a bounded cache keyed on
    ``(cfg, variant, compile kwargs)``. Repeated calls return the SAME
    Pipeline object, so device filter payloads and tuning lookups are
    warm. Unhashable kwarg values (dicts/lists, e.g. ``fft_kw``) are
    frozen to tuples for the key."""
    key = (cfg, variant, _freeze(kw))
    if key not in _PIPELINE_CACHE:
        import repro_torch.core.sar  # noqa: F401  (registers the variants)
        _fifo_put(_PIPELINE_CACHE, key, build_variant(cfg, variant, **kw),
                  _PIPELINE_CACHE_MAX)
    return _PIPELINE_CACHE[key]


def clear_pipeline_cache() -> None:
    _PIPELINE_CACHE.clear()
