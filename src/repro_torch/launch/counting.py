"""Count what a step does on each device, running it on meta tensors.

``MetaCounter`` is a ``TorchDispatchMode``: every aten op that reaches it
runs on meta (shapes and dtypes, nothing allocated or computed) and is
counted for the device it runs on, a mesh position of a production mesh
whose every device reads ``torch.device("meta")``. For each device:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` counts with: matmuls, convolutions, attention);
  elementwise ops count none, as there.
- **HBM bytes**: over every op, the bytes of its tensor operands and
  results (a view moves nothing and counts none; an op that only writes
  an operand, ``copy_`` / ``fill_`` / ``zero_``, does not read it; a
  factory of uninitialised memory writes nothing). This is the eager
  program's traffic, op by op, where XLA's "bytes accessed" is the fused
  program's, so it is larger than the reference's for the same math.
- **Temp bytes**: the high-water mark of the bytes created during the
  count and still alive, tracked by storage (a ``weakref.finalize`` on
  each new storage gives its bytes back).
- **Collectives**: the records ``distributed.mesh.note_collective`` makes
  at the port's copies between mesh positions, ``(op, bytes, group)``:
  the slabs' gathers and reductions, and each rank group's collectives
  at their shapes (``distributed.mesh.Group``: all-gathers of the stream,
  of MoE's expert outputs and of RG-LRU's ``xc``; reduce-scatters and
  all-reduces of row-parallel partial sums, Mamba's ``x_proj`` among
  them; the all-to-all of Mamba's ``in_proj`` blocks), and the
  all-gather that makes a rank's channel slice of a recurrent decode
  state whole in every copy (``launch.steps``).
- **Kernel launches** on meta (``kernels.ops.META_LISTENERS``), priced by
  ``tuning/cost.py``'s terms for that launch, not by the plain version.

Which device an op runs on: the slab work's position
(``distributed.mesh.placed``), else the tensor it writes in place, else
the rank or the data position whose compute runs (``models.sharding``),
else the first input whose storage the counter knows (one whose storage
holds more than one element first), else ``home`` (the first position's
device).
Arguments are made known with ``place``.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed.mesh import ShardedTensor, axis_positions
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rf
from repro_torch.models.sharding import current_position, current_rank
from repro_torch.tuning import cost

_aten = torch.ops.aten
# factories of uninitialised memory: their results are not written
_NO_WRITE = {_aten.empty.memory_format, _aten.empty_like.default,
             _aten.empty_strided.default, _aten.new_empty.default,
             _aten.new_empty_strided.default}
# ops whose results are not a function of their arguments' metadata
_NO_MEMO = {_aten.lift_fresh.default, _aten.lift_fresh_copy.default}
# ops that write their first operand without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}


@dataclasses.dataclass
class DeviceCounts:
    """One device's counts."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    live: int = 0
    peak: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0]))

    def roofline(self, model_flops: Optional[float] = None) -> rf.Roofline:
        return rf.from_counts(self.flops, self.hbm_bytes, self.collectives,
                              model_flops)

    def summary(self) -> dict:
        """The counts the symmetry of data positions is held to."""
        stats = rf.collective_stats(self.collectives)
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "temp_bytes": self.peak, "launches": dict(self.launches),
                "collective_bytes_by_op": stats.bytes_by_op,
                "collective_link_bytes": stats.link_bytes}


def _schema_info(func) -> tuple:
    """(is a view, names of the arguments it writes) of an aten op
    (``_unsafe_view`` is a view its schema does not mark)."""
    schema = func._schema
    view = func is _aten._unsafe_view.default or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in schema.returns)
    written = tuple(a.name for a in schema.arguments
                    if a.alias_info is not None and a.alias_info.is_write)
    return view, written


def _tensors(*values) -> list:
    """The tensors among ``values`` and the lists and tuples in them (an
    aten op's arguments and results nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out += [t for t in v if isinstance(t, torch.Tensor)]
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_HASHABLE = (bool, int, float, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _meta_key(value):
    """What a meta kernel's outputs depend on, of one argument: a meta
    tensor's shape, strides, offset and dtype, a scalar as itself (None
    for anything else, which is not memoised)."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "meta":
            return None
        return (value.shape, value.stride(), value.storage_offset(),
                value.dtype)
    if isinstance(value, (list, tuple)):
        keys = tuple(_meta_key(v) for v in value)
        return None if any(k is None and v is not None
                           for k, v in zip(keys, value)) else (keys,)
    return (type(value), value) if isinstance(value, _HASHABLE) else None


def _out_spec(out):
    """A meta result's shapes, strides and dtypes (None if it is not meta
    tensors)."""
    if isinstance(out, torch.Tensor):
        return ((out.shape, out.stride(), out.dtype)
                if out.device.type == "meta" else None)
    if isinstance(out, (list, tuple)) and out:
        specs = [_out_spec(t) for t in out]
        return None if None in specs else (type(out), specs)
    return None


def _from_spec(spec):
    if isinstance(spec[0], type):
        return spec[0](_from_spec(s) for s in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class MetaCounter(TorchDispatchMode):
    """Per-device counts of what runs inside it (see the module).

    ``mesh`` / ``rules``: the mesh the step runs over and its activation
    rules (the data positions are cut over ``rules["batch"]``); None for
    one device, whose coordinates are ``()``."""

    def __init__(self, mesh=None, rules: Optional[dict] = None):
        super().__init__()
        self.mesh = mesh
        if mesh is None:
            self.home = ()
            self._positions = [()]
        else:
            baxes = (rules or {}).get("batch") or ()
            baxes = (baxes,) if isinstance(baxes, str) else tuple(baxes)
            self._positions = [tuple(w.get(a, 0) for a in mesh.axis_names)
                               for w in axis_positions(mesh, baxes)]
            self.home = self._positions[0]
        self.devices: dict = defaultdict(DeviceCounts)
        self._tags: dict = {}
        self._info: dict = {}
        self._memo: dict = {}
        self._lock = threading.RLock()

    # ---- where work runs ---------------------------------------------------
    def _norm(self, coords) -> tuple:
        if isinstance(coords, (int, np.integer)):
            if self.mesh is None:
                return ()
            return tuple(int(c) for c in np.unravel_index(
                int(coords), self.mesh.devices.shape))
        return tuple(int(c) for c in coords)

    def _tag(self, t: torch.Tensor) -> Optional[tuple]:
        got = self._tags.get(id(t.untyped_storage()))
        return None if got is None else got[0]

    def _where(self, written=(), inputs=()) -> tuple:
        here = meshlib.current_placement()
        if here is not None:
            return self._norm(here)
        for t in written:
            tag = self._tag(t)
            if tag is not None:
                return tag
        rank = current_rank()
        if rank is not None and rank.group is not None:
            return self._norm(rank.group.coords[rank.index])
        pos = current_position()
        if pos is not None:
            return self._positions[pos.index]
        # a scalar (a learning rate, a norm, a loss's gradient, expanded
        # or not) lives on one device and goes to every other: an operand
        # whose storage holds more elements decides
        for t in sorted(inputs, key=lambda t: t.untyped_storage().nbytes()
                        <= t.element_size()):
            tag = self._tag(t)
            if tag is not None:
                return tag
        return self.home

    # ---- storages ------------------------------------------------------------
    def _track(self, t: torch.Tensor, coords: tuple, counted: bool):
        st = t.untyped_storage()
        key = id(st)
        if key in self._tags:
            return
        nbytes = st.nbytes() if counted else 0
        self._tags[key] = (coords, nbytes)
        if nbytes:
            dev = self.devices[coords]
            dev.live += nbytes
            dev.peak = max(dev.peak, dev.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        with self._lock:
            coords, nbytes = self._tags.pop(key, ((), 0))
            if nbytes:
                self.devices[coords].live -= nbytes

    def place(self, tree, coords=None):
        """Make ``tree``'s tensors known as arguments: a ``ShardedTensor``'s
        slabs at their mesh positions, a plain tensor at ``coords`` (home
        when None). Arguments are not temp bytes."""
        at = self.home if coords is None else self._norm(coords)
        leaves = tree_flatten(tree, is_leaf=lambda x: isinstance(
            x, ShardedTensor))[0]
        with self._lock:
            for leaf in leaves:
                if isinstance(leaf, ShardedTensor):
                    for c, slab in np.ndenumerate(leaf.slabs):
                        if slab is not None:
                            self._track(slab, self._norm(c), False)
                elif isinstance(leaf, torch.Tensor):
                    self._track(leaf, at, False)

    def created(self, tree, coords: Optional[tuple] = None) -> int:
        """The bytes of ``tree``'s storages made inside the counter (on
        the device at ``coords`` alone, when given), once each: a step's
        outputs."""
        seen, total = set(), 0
        leaves = tree_flatten(tree, is_leaf=lambda x: isinstance(
            x, ShardedTensor))[0]
        for leaf in leaves:
            ts = ([t for t in leaf.slabs.flat if t is not None]
                  if isinstance(leaf, ShardedTensor)
                  else [leaf] if isinstance(leaf, torch.Tensor) else [])
            for t in ts:
                key = id(t.untyped_storage())
                if key in seen or key not in self._tags:
                    continue
                seen.add(key)
                at, nbytes = self._tags[key]
                if coords is None or at == tuple(coords):
                    total += nbytes
        return total

    # ---- the records -------------------------------------------------------
    def _on_collective(self, op, nbytes, group, coords):
        with self._lock:
            at = self._norm(coords) if coords is not None else \
                self._where()
            self.devices[at].collectives.append((op, nbytes, group))

    def _on_launch(self, kernel, spec, xr, batch):
        if kernel == "spectral":
            lines = xr.shape[2] if spec.axis == 0 else xr.shape[1]
            got = cost.launch_counts(spec, batch, lines)
        else:
            got = cost.mega_launch_counts(spec, batch)
        with self._lock:
            at = self._where(inputs=(xr,))
            dev = self.devices[at]
            dev.flops += got["flops"]
            dev.hbm_bytes += got["bytes"]
            dev.launches[kernel] = dev.launches.get(kernel, 0) + 1
            rec = dev.ops[kernel]
            rec[0] += 1
            rec[1] += got["flops"]
            rec[2] += got["bytes"]

    def __enter__(self):
        meshlib._LISTENERS.append(self._on_collective)
        ops.META_LISTENERS.append(self._on_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            meshlib._LISTENERS.remove(self._on_collective)
            ops.META_LISTENERS.remove(self._on_launch)

    # ---- every op ------------------------------------------------------------
    def _run(self, func, args, kwargs):
        """``func`` on meta; an op that writes no argument and aliases
        none has its results' metadata memoised by its arguments' (the
        meta kernels of elementwise ops run in Python, ~0.3 ms each)."""
        key = _meta_key((args, tuple(sorted(kwargs.items()))))
        if key is None:
            return func(*args, **kwargs)
        spec = self._memo.get((func, key))
        if spec is not None:
            return _from_spec(spec)
        out = func(*args, **kwargs)
        spec = _out_spec(out)
        if spec is not None:
            self._memo[(func, key)] = spec
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _schema_info(func)
        view, written_names = info
        if view or written_names or func in _NO_MEMO:
            out = func(*args, **kwargs)
        else:
            out = self._run(func, args, kwargs)
        if view:
            return out
        results = _tensors(out)
        inputs = _tensors(*args, *kwargs.values())
        written = []
        if written_names:
            names = [a.name for a in func._schema.arguments]
            for i, name in enumerate(names):
                if name not in written_names:
                    continue
                written += _tensors(kwargs.get(
                    name, args[i] if i < len(args) else None))
        nbytes = 0
        if func not in _NO_WRITE:
            nbytes = sum(_nbytes(t) for t in inputs) + \
                sum(_nbytes(t) for t in results)
            if func in _WRITE_ONLY and inputs:
                nbytes -= _nbytes(inputs[0])
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        with self._lock:
            at = self._where(written, inputs)
            dev = self.devices[at]
            dev.flops += flops
            dev.hbm_bytes += nbytes
            rec = dev.ops[str(packet)]
            rec[0] += 1
            rec[1] += flops
            rec[2] += nbytes
            for t in results:
                self._track(t, at, True)
        return out

    # ---- results -----------------------------------------------------------
    def busiest(self) -> tuple:
        """The coordinates of the device whose roofline bound is largest
        (the first in mesh order among equals)."""
        if not self.devices:
            return self.home
        return max(sorted(self.devices),
                   key=lambda c: self.devices[c].roofline().bound)
