"""Multi-device SAR: per-device slabs with corner-turn collectives.

A SAR scene alternates between row-local (range) and column-local
(azimuth) stages, so the classic multi-device schedule is a "corner
turn" — an all-to-all that re-shards the matrix from azimuth-sharded to
range-sharded. The mesh is one process over a list of devices
(:class:`repro_torch.distributed.mesh.Mesh`): every slab is a tensor on
its device, every launch a launch of the hand-written kernels on one
slab, and every collective a set of copies between the slabs (peer copies
over NVLink between cards, on-card copies where the mesh repeats a
device). Two schedules are provided:

``corner2``  The 3-launch RDA (``fused3``) distributed directly: azimuth
             stages on column slabs, the fused range stage on row slabs,
             with a corner turn before and after it. 2 all-to-alls, every
             compute stage one spectral launch per device.

``halo``     The paper-ordered pipeline with ONE corner turn: range
             compression is row-local on the natural (azimuth-sharded)
             raw layout; after one corner turn the azimuth FFT and the
             azimuth compression are column-local, and the RCMC (which
             gathers at most ``halo`` range cells across the cut) uses a
             halo exchange with the two ring neighbours (``ppermute``)
             instead of a second all-to-all.

Beyond the two hand-written schedules, :func:`lower_pipeline` lowers ANY
transpose-free compiled plan, the single-launch megakernel family
(fused1 / csa_fused1 / omegak_fused1) included: a mega step splits at its
in-kernel corner-turn boundaries into per-device segment groups, one
megakernel launch per device per group, with the turns between groups
becoming the all-to-alls.

Every runner takes one scene ``(na, nr)`` or a batch ``(B, na, nr)``,
shards it along its first launch's line axis (corner2: range columns;
halo: azimuth rows) and returns the image gathered in scene order on the
mesh's first device, as ``Pipeline.run`` returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.plan import SpectralPlan, Stage, split, unsplit
from repro_torch.core.sar import filters
from repro_torch.core.sar.geometry import SceneConfig
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels.fft4step import (
    FILTER_FULL,
    FILTER_NONE,
    FILTER_OUTER,
    FILTER_SHARED,
    FILTER_SHARED_OUTER,
    resolve_precision,
)


def make_sar_mesh(axes=("data",), devices=None) -> Mesh:
    """A corner-turn mesh over ``devices``, by default every visible CUDA
    device sorted by index (raises without one, as the port's entry points
    do). A list that repeats a device emulates that many devices on it:
    ``make_sar_mesh(devices=[torch.device("cuda", 0)] * 8)`` runs a P = 8
    lowering on one card, ``[torch.device("cpu")] * 8`` on the CPU. With
    one axis name the mesh is flat; with two it is processes x local
    devices, ``(1, n)`` for this one process (the multi-host form is not
    ported)."""
    if isinstance(axes, str):
        axes = (axes,)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_sar_mesh runs on the GPUs by default; "
                "pass devices=[torch.device('cpu')] * P to emulate P "
                "devices on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if len(axes) == 1:
        return Mesh(devs, axes)
    if len(axes) == 2:
        arr = np.empty((1, len(devs)), dtype=object)
        arr[0, :] = devs
        return Mesh(arr, axes)
    raise ValueError(f"make_sar_mesh supports 1 or 2 axis names, got "
                     f"{axes!r}")


def _host(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _place(t: torch.Tensor, axis: Optional[int], devices) -> list:
    """One tensor per device: sliced along ``axis`` with the slabs, or
    the whole of it on each device when ``axis`` is None."""
    if axis is None:
        return [t.to(d) for d in devices]
    return meshlib.shard(t, axis, devices)


def _scene_slabs(raw, axis: int, devices) -> tuple:
    """A complex scene (or batch) cut into slabs along ``axis`` (a scene
    axis, after any batch dim), each split into re/im planes on its
    device."""
    x = torch.as_tensor(raw)
    if x.ndim not in (2, 3):
        raise ValueError("expected (na, nr) or (B, na, nr)")
    x = x.to(torch.complex64)
    bpre = x.ndim - 2
    planes = [split(s) for s in meshlib.shard(x, bpre + axis, devices)]
    return [r for r, _ in planes], [i for _, i in planes], bpre


def _image(xr: list, xi: list, axis: int, bpre: int) -> torch.Tensor:
    return unsplit(meshlib.unshard(xr, bpre + axis),
                   meshlib.unshard(xi, bpre + axis))


def _turn(slabs: list, from_axis: int, bpre: int, turn_dtype=None) -> list:
    """Re-shard: slabs sharded along scene axis ``from_axis`` become slabs
    sharded along the other one. ``turn_dtype`` narrows the payload on
    the wire (``torch.bfloat16``: rounded to nearest even both ways)."""
    split_axis = bpre + (1 - from_axis)
    concat_axis = bpre + from_axis
    dt = slabs[0].dtype
    if turn_dtype is not None:
        slabs = [s.to(turn_dtype) for s in slabs]
    out = meshlib.all_to_all(slabs, split_axis, concat_axis)
    if turn_dtype is not None:
        out = [s.to(dt) for s in out]
    return out


# ---------------------------------------------------------------------------
# Schedule 1: two corner turns around the fused range stage
# ---------------------------------------------------------------------------

def build_corner2(cfg: SceneConfig, mesh: Mesh, axes=("data",),
                  block: int = 8, col_block: int = 8,
                  fft_impl: str = "matmul", turn_dtype=None):
    """Returns ``fn(raw) -> image``: ``raw`` sharded along range columns,
    three spectral launches per device, two corner turns.

    turn_dtype: optional dtype of the corner-turn payload (e.g.
    ``torch.bfloat16``), halving the collective's bytes; its image is held
    within the 0.1 dB gate."""
    devices = mesh.device_list(axes)
    p = len(devices)
    if cfg.nr % p or cfg.na % p:
        raise ValueError(f"scene {cfg.na}x{cfg.nr} not divisible by {p} "
                         "devices")

    hr, hi = (_host(a) for a in filters.range_matched_filter(cfg))
    rc_u, rc_v = (_host(a) for a in filters.rcmc_phase_uv(cfg))
    az_u2, az_v2 = (_host(a) for a in filters.azimuth_phase_uv2(cfg))
    hr, hi, rc_v, az_v2 = ([_place(a, None, devices) for a in
                            (hr, hi, rc_v, az_v2)])
    # rc_u is per azimuth-frequency row: sharded with the row slabs;
    # az_u2 is per range gate: sharded with the column slabs
    rc_u = _place(rc_u, 0, devices)
    az_u2 = _place(az_u2, 0, devices)
    rkw = dict(block=block, fft_impl=fft_impl)
    ckw = dict(block=col_block, fft_impl=fft_impl)

    def run(raw):
        xr, xi, bpre = _scene_slabs(raw, 1, devices)   # (na, nr/P) slabs
        for i in range(p):
            xr[i], xi[i] = ops.fft_cols(xr[i], xi[i], **ckw)        # 1
        xr = _turn(xr, 1, bpre, turn_dtype)             # -> (na/P, nr)
        xi = _turn(xi, 1, bpre, turn_dtype)
        for i in range(p):
            xr[i], xi[i] = ops.fused_rc_rcmc_rows(
                xr[i], xi[i], hr[i], hi[i], rc_u[i], rc_v[i], **rkw)  # 2
        xr = _turn(xr, 0, bpre, turn_dtype)             # -> (na, nr/P)
        xi = _turn(xi, 0, bpre, turn_dtype)
        for i in range(p):
            xr[i], xi[i] = ops.fused_mult_ifft_cols_outer(
                xr[i], xi[i], az_u2[i], az_v2[i], **ckw)              # 3
        return _image(xr, xi, 1, bpre)

    run.devices = p
    run.dispatches_per_device = 3
    run.turns = 2
    return run


# ---------------------------------------------------------------------------
# Schedule 2: one corner turn + halo-exchange RCMC
# ---------------------------------------------------------------------------

def _halo_rcmc(xr: list, xi: list, cfg: SceneConfig, halo: int, p: int,
               taps: int = 8) -> tuple:
    """Sinc-interp RCMC on ``(na, nr/P)`` column slabs with a ring halo
    exchange.

    Every row's shift is at most ``halo - taps//2`` cells, so each device
    only needs ``halo`` columns from its right neighbour (the shift is
    non-negative: the migration curve moves content to larger range) and
    ``taps//2`` from its left one (the sinc taps reach left of it)."""
    lh = taps // 2
    perm_r = [((i + 1) % p, i) for i in range(p)]   # right neighbour -> me
    perm_l = [((i - 1) % p, i) for i in range(p)]   # left neighbour -> me

    def with_halo(slabs):
        from_right = meshlib.ppermute([x[..., :halo] for x in slabs], perm_r)
        from_left = meshlib.ppermute([x[..., -lh:] for x in slabs], perm_l)
        return [torch.cat([a, x, b], dim=-1)
                for a, x, b in zip(from_left, slabs, from_right)]

    hxr, hxi = with_halo(xr), with_halo(xi)
    s_np = filters.rcmc_shift_samples(cfg)
    offs = np.arange(taps) - taps // 2 + 1
    outr, outi = [], []
    for d in range(p):
        dev = xr[d].device
        nr_loc = xr[d].shape[-1]
        s = torch.as_tensor(s_np, dtype=torch.float32, device=dev)[:, None]
        base = torch.floor(s)
        frac = s - base
        xk = torch.as_tensor(offs, dtype=torch.float32,
                             device=dev)[None, None, :] - frac[..., None]
        w = torch.sinc(xk) * torch.where(
            torch.abs(xk) <= lh,
            0.54 + 0.46 * torch.cos(torch.pi * xk / lh),
            torch.zeros_like(xk))
        w = w / torch.sum(w, dim=-1, keepdim=True)
        cols = torch.arange(nr_loc, dtype=torch.int64, device=dev)[None, :]
        base_i = base.to(torch.int64)
        yr = torch.zeros_like(xr[d])
        yi = torch.zeros_like(xi[d])
        for k in range(taps):
            idx = torch.clamp(cols + lh + base_i + int(offs[k]), 0,
                              nr_loc + lh + halo - 1).expand(xr[d].shape)
            wk = w[..., k]
            yr = yr + torch.gather(hxr[d], -1, idx) * wk
            yi = yi + torch.gather(hxi[d], -1, idx) * wk
        outr.append(yr)
        outi.append(yi)
    return outr, outi


def plan_halo():
    """The one-device plan whose steps :func:`build_halo` distributes:
    range compression, the azimuth FFT, the 8-tap sinc RCMC and the
    azimuth compression by the on-chip rank-2 phase. Compiled, it gives
    the halo schedule's image bit for bit at any P."""
    return SpectralPlan("halo", (
        Stage("range_compression", axis=1, fwd=True, inv=True,
              filters=("range_mf",)),
        Stage("azimuth_fft", axis=0, fwd=True),
        Stage("rcmc", kind="sinc_rcmc"),
        Stage("azimuth_compression", axis=0, inv=True,
              filters=("azimuth_mf_outer",)),
    ))


def build_halo(cfg: SceneConfig, mesh: Mesh, axes=("data",),
               block: int = 8, col_block: int = 8, fft_impl: str = "matmul",
               halo: Optional[int] = None):
    """Returns ``fn(raw) -> image``: ``raw`` sharded along azimuth rows,
    three spectral launches per device, ONE corner turn and a ring halo
    exchange for the RCMC."""
    devices = mesh.device_list(axes)
    p = len(devices)
    if cfg.nr % p or cfg.na % p:
        raise ValueError(f"scene {cfg.na}x{cfg.nr} not divisible by {p} "
                         "devices")
    max_shift = float(np.max(filters.rcmc_shift_samples(cfg)))
    halo = halo or int(np.ceil(max_shift)) + 8
    if halo > cfg.nr // p:
        # the halo premise (halo << nr/P) fails: each device would need
        # more than its whole neighbour slab, i.e. the exchange
        # degenerates to a corner turn
        raise ValueError("halo exceeds local slab width; use corner2")

    hr, hi = (_place(_host(a), None, devices)
              for a in filters.range_matched_filter(cfg))
    az_u2, az_v2 = (_host(a) for a in filters.azimuth_phase_uv2(cfg))
    az_u2 = _place(az_u2, 0, devices)
    az_v2 = _place(az_v2, None, devices)
    rkw = dict(block=block, fft_impl=fft_impl)
    ckw = dict(block=col_block, fft_impl=fft_impl)

    def run(raw):
        xr, xi, bpre = _scene_slabs(raw, 0, devices)   # (na/P, nr) slabs
        for i in range(p):
            xr[i], xi[i] = ops.fused_fft_mult_ifft_rows(
                xr[i], xi[i], hr[i], hi[i], **rkw)                     # 1
        xr = _turn(xr, 0, bpre)                         # -> (na, nr/P)
        xi = _turn(xi, 0, bpre)
        for i in range(p):
            xr[i], xi[i] = ops.fft_cols(xr[i], xi[i], **ckw)          # 2
        xr, xi = _halo_rcmc(xr, xi, cfg, halo, p)
        for i in range(p):
            xr[i], xi[i] = ops.fused_mult_ifft_cols_outer(
                xr[i], xi[i], az_u2[i], az_v2[i], **ckw)              # 3
        return _image(xr, xi, 1, bpre)

    run.devices = p
    run.dispatches_per_device = 3
    run.turns = 1
    run.halo = halo
    return run


# ---------------------------------------------------------------------------
# Generic corner-turn lowering of a compiled SpectralPlan pipeline
# ---------------------------------------------------------------------------
#
# Every fused spectral launch processes lines independently — that is what
# lets the streaming executor strip a scene through host memory. The same
# property lets a compiled pipeline shard: each step runs on the slab
# sharded along its free (line) axis, and wherever two consecutive steps
# transform different axes the lowering inserts a corner turn
# (all-to-all). Line-indexed filter payloads (FULL matrices, OUTER u
# vectors) are sliced with the slab, so every device holds exactly its
# slab's slice; shared vectors and outer v factors are copied whole to
# each device. For the 3-launch RDA this reproduces the hand-written
# `corner2` schedule bit for bit.

def _spec_for_filter(name: str, arr, mode: str, stream_axis: int):
    """How one spectral-launch filter operand is sliced per device: the
    axis it is sharded along (its line axis), or None to copy it whole
    onto each device."""
    if name in ("hr", "hi"):
        if mode == FILTER_FULL and arr.ndim == 2:
            return stream_axis
        return None                        # shared (n,) vector
    if name == "u":                        # (lines, K): lines = stream axis
        return 0
    return None                            # v (n, K)


def _lowerable_steps(pipe) -> list:
    steps = list(pipe.steps)
    if not steps:
        raise ValueError(f"pipeline {pipe.name!r} has no steps")
    for s in steps:
        if s.kind == "mega":
            if s.kernel_kw is None or s.seg_filter_args is None:
                raise ValueError(
                    f"mega step {s.name!r} carries no per-segment filter "
                    "payloads (seg_filter_args); recompile the plan (e.g. "
                    "core.plan.compile_plan / cached_pipeline) and lower "
                    "the fresh pipeline")
            continue
        if (s.kind != "spectral" or s.stream_axis is None
                or s.kernel_kw is None):
            raise ValueError(
                f"step {s.name!r} (kind {s.kind!r}) cannot lower to "
                "per-device slabs: a transpose/custom stage reorders the "
                "whole scene, which no per-device slab can do locally. "
                "Compile a transpose-free per-axis variant (fused3 / "
                "csa_fused / omegak), or their single-dispatch megakernel "
                "twins (fused1 / csa_fused1 / omegak_fused1, "
                "fuse=FUSE_MEGA) whose in-kernel corner turns lower to "
                "all_to_all collectives; transposing variants run locally "
                "via Pipeline.run / run_streamed instead")
    return steps


def _clamped_block(kernel_kw: dict, lines_local: int) -> dict:
    """The per-launch line block must fit (and divide) the local slab."""
    kw = dict(kernel_kw)
    blk = min(int(kw.get("block") or 8), lines_local)
    while lines_local % blk:
        blk -= 1
    kw["block"] = max(1, blk)
    return kw


def _divisor_block(want: int, lines: int) -> int:
    """Largest block <= want that divides lines (>= 1)."""
    blk = min(int(want), int(lines))
    while lines % blk:
        blk -= 1
    return max(1, blk)


def _mega_groups(step):
    """Split a mega step's in-kernel segment chain at its corner-turn
    boundaries: consecutive same-axis segment records (with their
    scene-coordinate filter payloads) form one per-device group — one
    megakernel launch per device, the turns BETWEEN groups becoming
    all-to-all collectives. Returns
    ``[(axis, [records], [per-seg payload tuples]), ...]``."""
    recs = step.kernel_kw["segments"]
    fargs = step.seg_filter_args
    if len(recs) != len(fargs):
        raise ValueError(
            f"mega step {step.name!r}: {len(recs)} segment records but "
            f"{len(fargs)} per-segment filter payloads")
    groups: list = []
    for rec, fa in zip(recs, fargs):
        axis = rec[0]
        if groups and groups[-1][0] == axis:
            groups[-1][1].append(rec)
            groups[-1][2].append(tuple(fa))
        else:
            groups.append((axis, [rec], [tuple(fa)]))
    return groups


def _mega_filter_specs(mode: str, arrays, stream_axis: int) -> list:
    """How each array of one mega segment's scene-coordinate payload is
    sliced per device (an axis, or None for a whole copy on each).

    The free (line) axis is the sharded one: FULL 2-D filters and OUTER
    ``u`` factors slice with the slab; SHARED vectors (the complete
    transform axis) and OUTER ``v`` factors are copied whole."""
    def line_sharded(a):
        return stream_axis if a.ndim == 2 else None

    specs: list = []
    arrays = list(arrays)
    if mode in (FILTER_SHARED, FILTER_FULL, FILTER_SHARED_OUTER):
        for a in arrays[:2]:
            # SHARED payloads are 1-D (whole transform axis); a 2-D
            # payload is a FULL scene-shaped filter, sliced like x
            specs.append(line_sharded(a) if mode != FILTER_SHARED else None)
    if mode in (FILTER_OUTER, FILTER_SHARED_OUTER):
        # u is (lines, K): lines IS the sharded free axis; v is (n, K) on
        # the complete transform axis
        specs += [0, None]
    if mode == FILTER_NONE and arrays:
        raise ValueError("filter-less segment carries payload arrays")
    return specs


# kernel knobs a mega step's kernel_kw shares with every per-device group
_MEGA_GROUP_KW = ("fft_impl", "precision", "karatsuba", "buffer_depth")


def _group_mega_kw(src: dict, recs, stream_axis: int, lines_local: int,
                   na_local: int, nr_local: int, filter_bytes: int,
                   residency: Optional[str]) -> dict:
    """The ``ops.mega_spectral_op`` keywords of ONE per-device segment
    group: the parent launch's global knobs, the group's own segment
    records, a phase_block clamped to divide the LOCAL free-axis lines,
    and the residency re-resolved for the 1/P slab (unless pinned)."""
    kw = {k: src[k] for k in _MEGA_GROUP_KW if k in src}
    kw["segments"] = tuple(recs)
    if stream_axis == 0:
        # row slab (na/P, nr): the global n1/n2/n3 range-axis override
        # still factors this slab's full-width range axis. Column slabs
        # slice the range axis, so a full-width factorization would no
        # longer multiply out — azimuth groups take the default split
        # (per-segment 8-field records stay valid either way: they factor
        # the transform axis, which sharding never slices).
        for k in ("n1", "n2", "n3"):
            kw[k] = src.get(k)
    kw["phase_block"] = _divisor_block(src.get("phase_block") or 8,
                                       lines_local)
    if residency is None:
        residency = ops.mega_residency(
            na_local, nr_local, precision=src.get("precision"),
            filter_bytes=filter_bytes,
            splits=ops.mega_splits(na_local, nr_local, kw["segments"],
                                   n1=kw.get("n1"), n2=kw.get("n2"),
                                   n3=kw.get("n3"),
                                   fft_impl=kw.get("fft_impl", "matmul")))
    kw["residency"] = residency
    return kw


@dataclasses.dataclass(frozen=True)
class Unit:
    """One per-device launch of a lowering: ``kind`` "spectral" runs
    ``ops.spectral_op(xr, xi, **filter_args[i], **kernel_kw)`` on device
    ``i``'s slab, "mega" ``ops.mega_spectral_op(xr, xi, *filter_args[i],
    **kernel_kw)``; ``filter_args[i]`` holds device ``i``'s slices of the
    filter payloads."""

    stream_axis: int
    name: str
    kind: str                      # "spectral" | "mega"
    kernel_kw: dict
    filter_args: tuple             # one per device: dict | tuple

    @property
    def residency(self) -> Optional[str]:
        return self.kernel_kw["residency"] if self.kind == "mega" else None

    @property
    def carries_exponents(self) -> bool:
        """A block-scaled mega group chains its per-line exponents through
        the turns (``ops.mega_spectral_op`` exp_in / return_exp)."""
        return self.kind == "mega" and resolve_precision(
            self.kernel_kw.get("precision")).block_scaled

    def apply(self, i: int, xr, xi, exp_in=None, return_exp=False):
        if self.kind == "spectral":
            return ops.spectral_op(xr, xi, **self.filter_args[i],
                                   **self.kernel_kw)
        return ops.mega_spectral_op(xr, xi, *self.filter_args[i],
                                    exp_in=exp_in, return_exp=return_exp,
                                    **self.kernel_kw)


def lower_pipeline(pipe, mesh: Mesh, axes=("data",), turn_dtype=None,
                   residency: Optional[str] = None):
    """Lower a compiled :class:`~repro_torch.core.plan.Pipeline` onto
    ``mesh``.

    Returns ``fn(raw) -> image`` accepting one scene ``(na, nr)`` or a
    batch ``(B, na, nr)``, complex64. The input is sharded along the
    FIRST unit's line axis and the image comes back gathered in scene
    order on the mesh's first device.

    Spectral steps lower one-to-one: each runs ``ops.spectral_op`` on the
    slab sharded along its free (line) axis. A MEGA step is split at its
    in-kernel corner-turn boundaries into per-device segment groups
    (range segments on range-sharded ``(na/P, nr)`` slabs, azimuth
    segments on ``(na, nr/P)``): each group is ONE
    ``ops.mega_spectral_op`` launch per device, and the in-kernel turns
    between groups become the all-to-alls. ``residency`` pins every
    group's kernel ('vmem' | 'staged'); the default re-resolves per group
    on the 1/P slab (``ops.mega_residency``), so a 256^2 scene that must
    stage locally runs resident per device.

    Collective cost: one all-to-all of the full scene per axis change
    (``tuning.cost.collective_turn_bytes`` / ``turn_seconds`` price it),
    halved by ``turn_dtype=torch.bfloat16``. Block-scaled (bs16) mega
    chains keep the slab SCALED on the wire and all-gather the carried
    per-line exponent vector beside it, then unscale after the turn:
    power-of-two scaling is exact, so the sharded bs16 image equals the
    local megakernel's bit for bit (a line's exponent never depends on
    how the free axis was sharded). fused3 / csa_fused / omegak and the
    fused1 family all lower with exactly 2 turns.

    The runner carries the lowering's shape: ``devices``,
    ``dispatches_per_device`` (units), ``turns`` (collective corner
    turns), ``unit_info`` (name / stream axis / kind / residency per
    unit) and ``units`` (the :class:`Unit` records: each launch, its
    keywords and its per-device payloads, callable on its own)."""
    devices = mesh.device_list(axes)
    p = len(devices)
    cfg = pipe.cfg
    steps = _lowerable_steps(pipe)
    units: list = []

    def check_lines(stream: int, label: str) -> int:
        lines = cfg.na if stream == 0 else cfg.nr
        if lines % p:
            raise ValueError(
                f"unit {label!r}: {lines} lines not divisible by {p} "
                "devices")
        return lines // p

    def add_spectral(s):
        lines_local = check_lines(s.stream_axis, s.name)
        per_dev = [{} for _ in devices]
        for name in sorted((s.filter_kw or {}).keys()):
            arr = s.filter_kw[name]
            ax = _spec_for_filter(name, arr, s.filter_mode, s.stream_axis)
            for i, slab in enumerate(_place(arr, ax, devices)):
                per_dev[i][name] = slab
        units.append(Unit(s.stream_axis, s.name, "spectral",
                          _clamped_block(s.kernel_kw, lines_local),
                          tuple(per_dev)))

    def add_mega(s):
        for gi, (axis, recs, seg_fargs) in enumerate(_mega_groups(s)):
            stream = 1 - axis
            label = f"{s.name}[g{gi}]"
            lines_local = check_lines(stream, label)
            per_dev = [[] for _ in devices]
            fbytes = 0
            for rec, fa in zip(recs, seg_fargs):
                mode = rec[3]
                specs = _mega_filter_specs(mode, fa, stream)
                if len(specs) != len(fa):
                    raise ValueError(
                        f"mega step {s.name!r} group {gi}: segment mode "
                        f"{mode!r} expects {len(specs)} payload arrays, "
                        f"got {len(fa)}")
                for a, ax in zip(fa, specs):
                    for i, slab in enumerate(_place(a, ax, devices)):
                        per_dev[i].append(slab)
                fbytes += sum(int(a.numel()) * 4 // p for a in fa)
            na_l = cfg.na // p if stream == 0 else cfg.na
            nr_l = cfg.nr if stream == 0 else cfg.nr // p
            kw = _group_mega_kw(s.kernel_kw, recs, stream, lines_local,
                                na_l, nr_l, fbytes, residency)
            units.append(Unit(stream, label, "mega", kw,
                              tuple(tuple(f) for f in per_dev)))

    for s in steps:
        (add_mega if s.kind == "mega" else add_spectral)(s)

    n_turns = sum(1 for a, b in zip(units, units[1:])
                  if a.stream_axis != b.stream_axis)

    def run(raw):
        cur = units[0].stream_axis
        xr, xi, bpre = _scene_slabs(raw, cur, devices)
        exp = None
        for k, u in enumerate(units):
            if u.stream_axis != cur:
                xr = _turn(xr, cur, bpre, turn_dtype)
                xi = _turn(xi, cur, bpre, turn_dtype)
                if exp is not None:
                    # the carried per-line exponents ride the turn with
                    # the (still scaled) slab: they are sharded along
                    # their own line axis — the PREVIOUS group's stream
                    # axis — and after the turn every device's slab spans
                    # all of those lines, so an all-gather restores the
                    # whole vector on each device
                    exp = meshlib.all_gather(exp, bpre + cur)
                cur = u.stream_axis
            chain = (u.carries_exponents and k + 1 < len(units)
                     and units[k + 1].carries_exponents)
            out_exp = []
            for i in range(p):
                e_in = exp[i] if exp is not None else None
                if chain:
                    xr[i], xi[i], e = u.apply(i, xr[i], xi[i], exp_in=e_in,
                                              return_exp=True)
                    out_exp.append(e)
                else:
                    xr[i], xi[i] = u.apply(i, xr[i], xi[i], exp_in=e_in)
            exp = out_exp if chain else None
        return _image(xr, xi, cur, bpre)

    run.devices = p
    run.dispatches_per_device = len(units)
    run.turns = n_turns
    run.units = tuple(units)
    run.unit_info = tuple(
        {"name": u.name, "stream_axis": u.stream_axis, "kind": u.kind,
         "residency": u.residency, "carries_exponents": u.carries_exponents}
        for u in units)
    return run


def build_sharded(cfg: SceneConfig, variant: str = "fused3",
                  mesh: Optional[Mesh] = None, axes=("data",),
                  schedule: str = "corner2", turn_dtype=None, **compile_kw):
    """Compile ``variant`` for ``cfg`` and return a multi-device runner.

    schedule 'corner2': the generic plan lowering (:func:`lower_pipeline`)
    — an all-to-all corner turn at every transform-axis change; works for
    any transpose-free spectral plan and reproduces the hand-written
    corner2 schedule exactly on the 3-launch RDA. ``compile_kw``
    (precision, block, fft_kw, ...) route to the plan compiler, which
    compiles on the mesh's first device unless told otherwise.

    schedule 'halo': the hand-written single-turn RDA schedule
    (:func:`build_halo`) — range compression on the natural pulse-sharded
    layout, ONE corner turn, ring halo-exchange RCMC. RDA only; the
    ``variant`` argument selects nothing beyond asserting RDA semantics.

    ``mesh=None`` is :func:`make_sar_mesh` over every visible card. This
    is the focusing service's ``sharded`` backend
    (``repro_torch.service.backends.ShardedBackend``)."""
    if mesh is None:
        mesh = make_sar_mesh(axes)
    if schedule == "halo":
        if variant not in ("fused3", "fused_tfree", "fused", "unfused"):
            raise ValueError(
                f"schedule 'halo' implements the RDA; variant {variant!r} "
                "is not an RDA pipeline (use schedule='corner2')")
        supported = ("block", "col_block", "fft_impl", "halo")
        ignored = sorted(set(compile_kw) - set(supported))
        if ignored or turn_dtype is not None:
            # refuse rather than silently run f32/full-width: a client
            # that asked for precision='bf16' must not get an unlabelled
            # f32 result back
            bad = ignored + (["turn_dtype"] if turn_dtype is not None
                             else [])
            raise ValueError(
                f"schedule 'halo' does not support option(s) {bad}; "
                "use schedule='corner2' for precision/turn_dtype")
        return build_halo(cfg, mesh, axes, **compile_kw)
    if schedule != "corner2":
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"known: corner2, halo")
    from repro_torch.core.sar.rda import build_pipeline
    compile_kw.setdefault("device", mesh.device_list(axes)[0])
    pipe = build_pipeline(cfg, variant, **compile_kw)
    return lower_pipeline(pipe, mesh, axes=axes, turn_dtype=turn_dtype)


SCHEDULES = {"corner2": build_corner2, "halo": build_halo}


def distributed_focus(raw, cfg: SceneConfig, mesh: Mesh, axes=("data",),
                      schedule: str = "corner2", **kw):
    return SCHEDULES[schedule](cfg, mesh, axes, **kw)(raw)
