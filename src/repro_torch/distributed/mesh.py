"""A single-process device mesh and its three collectives.

The port's counterpart of what JAX itself gives the reference
(``jax.sharding.Mesh`` and ``jax.lax.all_to_all`` / ``ppermute`` /
``all_gather`` under ``shard_map``): one process drives every device of
the mesh, a sharded tensor is a list of per-device slabs (one tensor per
mesh position, in mesh order), and a collective is a set of copies
between those slabs — ``Tensor.to`` / ``narrow`` / ``torch.cat``, peer
copies over NVLink between cards, plain copies on one device.

A layout that keeps copies (``NamedSharding``, below) is the port's
counterpart of ``jax.sharding.NamedSharding`` / ``PartitionSpec``: a
spec gives each dimension of a tensor None (whole), a mesh axis, or a
tuple of axes (major to minor), and every mesh position holds the slab
its coordinates select, so positions that differ only along axes the
spec does not name hold copies. ``distribute`` takes a tensor to its
``ShardedTensor`` of slabs, ``ShardedTensor.gather`` takes it back by
placing the slabs (exact, whatever the dtype).

A mesh may name one device more than once: ``Mesh([cuda:0] * 8)`` runs the
eight slabs of a P = 8 lowering on one card (each slab its own launches,
each turn on-card copies), and ``Mesh([cpu] * 8)`` runs them on the CPU,
as the reference's tests emulate 8 XLA CPU devices in one process. A mesh
refuses devices of different types: a CPU slab beside CUDA slabs would run
the plain version where the others launch kernels.

Streams: every copy is issued on the current stream of the devices it
touches. PyTorch orders a cross-device ``copy_`` against the current
streams of both devices, and a ``torch.cuda.stream(s)`` context sets the
current stream of ``s``'s device alone, so a caller driving a multi-card
mesh from a side stream must hold one such stream per card.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

AxisNames = Union[str, Sequence[str]]


def _as_axes(axes: AxisNames) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` shaped by ``axis_names``."""

    def __init__(self, devices, axis_names: AxisNames = ("data",)):
        names = _as_axes(axis_names)
        devs = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[idx] = torch.device(d)
        if devs.ndim == 1 and len(names) > 1:
            raise ValueError(f"{len(names)} axis names for a 1-D device list;"
                             " pass the devices shaped by the axes")
        if devs.ndim != len(names):
            raise ValueError(f"devices of shape {devs.shape} do not match "
                             f"axis names {names!r}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs.flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh takes one device type, got "
                             f"{sorted(kinds)}")
        self.devices = devs
        self.axis_names = names
        self.shape = dict(zip(names, devs.shape))

    def size(self, axes: AxisNames = None) -> int:
        """Devices along ``axes`` (all of them when None)."""
        if axes is None:
            return int(self.devices.size)
        return int(np.prod([self.shape[a] for a in _as_axes(axes)]))

    def device_list(self, axes: AxisNames = None) -> list:
        """The devices one slab each, in mesh order, for a tensor sharded
        along ``axes`` (the collectives below take one slab a device).
        Every mesh axis of more than one device must be among them: a
        layout with slabs replicated over an axis is a ``NamedSharding``."""
        if axes is not None:
            named = set(_as_axes(axes))
            unknown = named - set(self.axis_names)
            if unknown:
                raise ValueError(f"axes {sorted(unknown)} are not mesh axes "
                                 f"{self.axis_names!r}")
            spare = [a for a in self.axis_names
                     if a not in named and self.shape[a] > 1]
            if spare:
                raise ValueError(
                    f"mesh axes {spare} are not sharded over; slabs "
                    "replicated over a mesh axis take a NamedSharding")
            order = [self.axis_names.index(a) for a in _as_axes(axes)]
            rest = [i for i in range(self.devices.ndim) if i not in order]
            devs = np.transpose(self.devices, order + rest)
        else:
            devs = self.devices
        return list(devs.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


# ---------------------------------------------------------------------------
# What a dry run (``launch/dryrun.py``) reads off the mesh: a record of
# every copy between mesh positions, the position each slab's work runs
# at, and a view that holds one position's slabs. Outside a dry run no
# listener is registered and no view is set, and they change nothing.
# ---------------------------------------------------------------------------

_LISTENERS: list = []
_here = threading.local()
_VIEW: list = [None]


def note_collective(op: str, nbytes: int, group: int, coords=None):
    """Tell the listeners of one device's part in a collective: ``op`` in
    the reference's HLO names, ``nbytes`` its output on that device,
    ``group`` the devices taking part, ``coords`` the device (its mesh
    coordinates, or its index in a slab list; None: where the work runs
    now)."""
    for fn in _LISTENERS:
        fn(op, int(nbytes), int(group), coords)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def placed(coords):
    """The work inside runs on the device at ``coords`` (mesh coordinates,
    or an index into a slab list)."""
    prev = getattr(_here, "coords", None)
    _here.coords = coords
    try:
        yield
    finally:
        _here.coords = prev


def current_placement():
    return getattr(_here, "coords", None)


@contextlib.contextmanager
def view(coords: tuple):
    """Within it, every ``ShardedTensor``'s slab-by-slab work (``items``,
    ``write``, ``sq_sum``) visits the slabs at mesh ``coords`` alone, a
    new one (``sharded_empty``) is made there alone (its other slabs are
    None), and the data positions whose device is not at ``coords`` are
    not run: their results are the first held position's (same code, same
    shapes; ``models.sharding.run_positions``). Gathers still read every
    slab. A dry run counts one device's work so, on meta tensors."""
    prev = _VIEW[0]
    _VIEW[0] = tuple(coords)
    try:
        yield
    finally:
        _VIEW[0] = prev


def current_view() -> Optional[tuple]:
    return _VIEW[0]


def shard(x: torch.Tensor, axis: int, devices: Sequence) -> list:
    """``x`` cut into ``len(devices)`` equal slabs along ``axis``, slab i
    contiguous on ``devices[i]``."""
    p = len(devices)
    n = x.shape[axis]
    if n % p:
        raise ValueError(f"{n} lines along axis {axis} not divisible by "
                         f"{p} devices")
    c = n // p
    out = []
    for i, d in enumerate(devices):
        with placed(i):
            out.append(x.narrow(axis, i * c, c).contiguous().to(d))
    return out


def unshard(slabs: Sequence[torch.Tensor], axis: int,
            device=None) -> torch.Tensor:
    """The slabs concatenated in mesh order along ``axis`` on ``device``
    (the first slab's when None)."""
    dev = slabs[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in slabs], dim=axis)


def all_to_all(slabs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> list:
    """The tiled all-to-all: each source slab is cut into P chunks along
    ``split_axis``, and device j gets chunk j of every source,
    concatenated in source order along ``concat_axis``."""
    p = len(slabs)
    n = slabs[0].shape[split_axis]
    if n % p:
        raise ValueError(f"split axis of {n} not divisible by {p} devices")
    c = n // p
    out = []
    for j, dst in enumerate(s.device for s in slabs):
        with placed(j):
            out.append(torch.cat([s.narrow(split_axis, j * c, c).to(dst)
                                  for s in slabs], dim=concat_axis))
        note_collective("all-to-all", _nbytes(out[-1]), p, j)
    return out


def ppermute(slabs: Sequence[torch.Tensor], perm) -> list:
    """``perm`` is a list of ``(source, destination)`` pairs: destination
    d gets source s's slab on its own device; a device no pair names as a
    destination gets zeros, as ``jax.lax.ppermute`` gives it."""
    out = []
    for j, s in enumerate(slabs):
        with placed(j):
            out.append(torch.zeros_like(s))
    dests = set()
    for src, dst in perm:
        if dst in dests:
            raise ValueError(f"device {dst} is the destination of two pairs")
        dests.add(dst)
        with placed(dst):
            out[dst] = slabs[src].to(slabs[dst].device)
        note_collective("collective-permute", _nbytes(out[dst]),
                        len(slabs), dst)
    return out


def all_gather(slabs: Sequence[torch.Tensor], axis: int) -> list:
    """The tiled all-gather: every device gets every slab, concatenated
    in mesh order along ``axis``, on its own device."""
    out = []
    for j, s in enumerate(slabs):
        with placed(j):
            out.append(unshard(slabs, axis, s.device))
        note_collective("all-gather", _nbytes(out[-1]), len(slabs), j)
    return out


# ---------------------------------------------------------------------------
# Layouts with copies: PartitionSpec, NamedSharding, ShardedTensor
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a dimension: None (whole), a mesh axis name, or a tuple
    of axis names (the dimension cut over their product, the first axis
    major). Trailing dimensions past the entries are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A tensor's layout on ``mesh``: ``spec`` names the mesh axes each
    dimension is cut over."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        named = [a for e in spec for a in _entry_axes(e)]
        unknown = set(named) - set(mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {spec!r} names axes {sorted(unknown)} "
                             f"not on the mesh {mesh.axis_names!r}")
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec!r} names an axis twice")
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec!r} for a tensor of {ndim} "
                             "dimensions")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def parts(self, ndim: int) -> list:
        """The number of slabs along each dimension."""
        return [self.mesh.size(_entry_axes(e)) if e is not None else 1
                for e in self._entries(ndim)]

    def shard_shape(self, shape) -> tuple:
        """The shape of every slab; raises where a dimension does not
        divide its axes."""
        out = []
        for d, n in zip(shape, self.parts(len(shape))):
            if d % n:
                raise ValueError(f"dimension of {d} does not divide over "
                                 f"{n} devices ({self.spec!r})")
            out.append(d // n)
        return tuple(out)

    def block_index(self, coords: tuple, ndim: int) -> tuple:
        """The slab's index along each dimension at mesh ``coords``."""
        pos = dict(zip(self.mesh.axis_names, coords))
        out = []
        for e in self._entries(ndim):
            i = 0
            for a in _entry_axes(e):
                i = i * self.mesh.shape[a] + pos[a]
            out.append(i)
        return tuple(out)

    def slices(self, coords: tuple, shape) -> tuple:
        """The slab at mesh ``coords`` as slices of the whole tensor."""
        sub = self.shard_shape(shape)
        return tuple(slice(i * s, (i + 1) * s) for i, s in
                     zip(self.block_index(coords, len(shape)), sub))


def shard_shape(shape, sharding: NamedSharding) -> tuple:
    """The shape each device holds of a tensor of ``shape``."""
    return sharding.shard_shape(shape)


class ShardedTensor:
    """A tensor laid out by a ``NamedSharding``: ``slabs`` is a numpy
    object array shaped as the mesh's devices, the slab at each position
    on that position's device. Positions whose coordinates differ only
    along axes the spec does not name hold copies of one slab."""

    def __init__(self, slabs: np.ndarray, sharding: NamedSharding, shape):
        self.slabs = slabs
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = next(t for t in slabs.flat if t is not None).dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def __repr__(self) -> str:
        return (f"ShardedTensor({list(self.shape)}, {self.dtype}, "
                f"{self.sharding!r})")

    def items(self):
        """(mesh coords, slab) for every position, in mesh order (the
        view's position alone within ``view``)."""
        held = current_view()
        if held is None:
            return np.ndenumerate(self.slabs)
        return iter([(held, self.slabs[held])])

    def nbytes(self) -> int:
        """The bytes the slabs hold, copies included."""
        return sum(t.numel() * t.element_size() for _, t in self.items())

    def _block(self, where: Optional[dict]) -> tuple:
        """The part of the tensor the positions at ``where`` (axis ->
        index) cover, as slices; a dimension cut over some of ``where``'s
        axes must be cut over all of its axes among them or none."""
        where = where or {}
        out = []
        for dim, e in zip(self.shape, self.sharding._entries(len(
                self.shape))):
            axes = _entry_axes(e)
            pinned = [a for a in axes if a in where]
            if not pinned:
                out.append(slice(0, dim))
                continue
            if pinned != list(axes[:len(pinned)]):
                raise ValueError(f"axes {pinned} pin a dimension cut over "
                                 f"{axes}: pin its major axes first")
            i = 0
            for a in pinned:
                i = i * self.mesh.shape[a] + where[a]
            n = self.mesh.size(pinned)
            out.append(slice(i * dim // n, (i + 1) * dim // n))
        return tuple(out)

    def _overlaps(self, block: tuple, copies: bool, every: bool = False):
        """(slab, slices of the slab, slices of ``block``) for each slab
        overlapping ``block``: every copy, or (``copies`` False) the first
        position in mesh order holding each slab; among ``items``' slabs,
        or (``every``) among all of them whatever the view."""
        seen = set()
        ndim = len(self.shape)
        sub = self.sharding.shard_shape(self.shape)
        slabs = np.ndenumerate(self.slabs) if every else self.items()
        for coords, slab in slabs:
            idx = self.sharding.block_index(coords, ndim)
            if not copies:
                if idx in seen:
                    continue
                seen.add(idx)
            inner, local = [], []
            for i, n, b in zip(idx, sub, block):
                lo, hi = max(i * n, b.start), min((i + 1) * n, b.stop)
                if lo >= hi:
                    break
                inner.append(slice(lo - i * n, hi - i * n))
                local.append(slice(lo - b.start, hi - b.start))
            else:
                yield slab, tuple(inner), tuple(local)

    def gather(self, device=None, where: Optional[dict] = None
               ) -> torch.Tensor:
        """The whole tensor (or the block the positions at ``where``
        cover) on ``device`` (the first slab's when None), placed from
        one copy of each slab: exact. A block that is one slab on
        ``device`` is that slab itself, not a copy."""
        block = self._block(where)
        dev = self.slabs.flat[0].device if device is None else \
            torch.device(device)
        parts = list(self._overlaps(block, copies=False, every=True))
        shape = tuple(b.stop - b.start for b in block)
        if len(parts) == 1:
            slab = parts[0][0]
            if slab.device == dev and tuple(slab.shape) == shape:
                return slab
        out = torch.empty(shape, dtype=self.dtype, device=dev)
        for slab, inner, local in parts:
            whole = all(s.start == 0 and s.stop == n
                        for s, n in zip(inner, slab.shape))
            out[local] = (slab if whole else slab[inner]).to(dev)
        if len(parts) > 1:
            note_collective("all-gather", _nbytes(out), len(parts))
        return out

    def sq_sum(self) -> torch.Tensor:
        """The float32 sum of squares of the whole tensor: one copy of
        each slab, each slab's sum on its device, added on the first
        slab's."""
        dev = self.slabs.flat[0].device
        total = None
        for slab, _, _ in self._overlaps(self._block(None), copies=False):
            part = torch.sum(torch.square(slab.to(torch.float32))).to(dev)
            total = part if total is None else total + part
        return total

    def write(self, value: torch.Tensor, start: Sequence[int] = None):
        """Copy ``value`` into every slab (each copy) at the whole
        tensor's offsets ``start`` (0 along every dimension when None)."""
        start = [0] * len(self.shape) if start is None else list(start)
        block = tuple(slice(s, s + n) for s, n in zip(start, value.shape))
        for slab, inner, local in self._overlaps(block, copies=True):
            src, dst = value[local], slab[inner]
            if not _same_memory(src, dst):
                dst.copy_(src)

    def write_block(self, value: torch.Tensor, where: dict):
        """Copy ``value``, the block the positions at ``where`` cover, into
        every slab holding part of it."""
        self.write(value, [b.start for b in self._block(where)])



def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` start at the same memory (on meta, where
    every storage starts at address 0: the same storage and offset)."""
    if a.device != b.device:
        return False
    if a.device.type == "meta":
        return (a.untyped_storage() is b.untyped_storage()
                and a.storage_offset() == b.storage_offset())
    return a.data_ptr() == b.data_ptr()


def distribute(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` laid out by ``sharding``: every position gets its own copy of
    its slab, contiguous on its device."""
    mesh = sharding.mesh
    sharding.shard_shape(x.shape)
    slabs = np.empty(mesh.devices.shape, dtype=object)
    for coords, dev in np.ndenumerate(mesh.devices):
        with placed(coords):
            part = x[sharding.slices(coords, x.shape)]
            slabs[coords] = part.to(dev, copy=True).contiguous()
    return ShardedTensor(slabs, sharding, x.shape)


def sharded_empty(shape, sharding: NamedSharding, dtype=torch.float32,
                  fill=torch.empty) -> ShardedTensor:
    """A tensor laid out by ``sharding``, allocated slab by slab with
    ``fill`` (``torch.empty``, or ``torch.zeros``: ``sharded_zeros``)."""
    sub = sharding.shard_shape(shape)
    slabs = np.empty(sharding.mesh.devices.shape, dtype=object)
    held = current_view()
    for coords, dev in np.ndenumerate(sharding.mesh.devices):
        if held is not None and coords != held:
            continue    # within a view, a slab it does not hold stays None
        with placed(coords):
            slabs[coords] = fill(sub, dtype=dtype, device=dev)
    return ShardedTensor(slabs, sharding, shape)


def sharded_zeros(shape, sharding: NamedSharding,
                  dtype=torch.float32) -> ShardedTensor:
    return sharded_empty(shape, sharding, dtype, torch.zeros)


def axis_positions(mesh: Mesh, axes: Sequence[str]) -> list:
    """Every combination of indices along ``axes`` (``{axis: index}``),
    the first axis major: the mesh order of positions cut over them."""
    axes = [a for a in axes if a in mesh.axis_names]
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for flat in range(math.prod(sizes)):
        idx, rest = {}, flat
        for a, n in reversed(list(zip(axes, sizes))):
            idx[a] = rest % n
            rest //= n
        out.append({a: idx[a] for a in axes})
    return out


def position_device(mesh: Mesh, where: dict) -> torch.device:
    """The device of the first mesh position at ``where``."""
    idx = tuple(where.get(a, 0) for a in mesh.axis_names)
    return mesh.devices[idx]
