"""Logical-axis sharding constraints for model code.

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "heads")``). A launch-layer context maps
logical names to mesh axes; outside any context the calls are identity,
so unit tests and single-card runs are unaffected.

How the port runs a mesh (``launch/steps.py``): the parameters, the
optimizer's moments and the decode caches are stored in the reference's
layout (``launch/sharding.py``, ``distributed.mesh.ShardedTensor``), and
each data position — one index along the batch axes — runs the model on
its part of the batch with every weight gathered whole on its device.
So inside a data position's compute every tensor is local and whole:
``shard`` is the identity and ``gather_for_compute``'s gather has
already happened, exactly (by placing the slabs), before the compute.
``axis_size`` answers the mesh's sizes, so the model code takes the
reference's branches (``attention._kv_spec``, MoE's expert parallelism).

Two things cross data positions inside the compute, and ``Position``
carries them: MoE routing groups, which are groups of the flattened
*global* batch (a group spanning positions is routed whole: the
positions run in lockstep threads and all-gather their top-k choices
through ``Exchange``), and the loss's and aux loss's normalisation
(each position's loss is its share of the global mean, so the sum over
positions is the global loss and the sum of their gradients the global
gradient).

Tensor-parallel compute over "model" is not part of this port: "model"
shards storage (parameters, moments, KV caches) only.

Default production rules:
  batch   -> ("pod", "data")     data parallel
  seq     -> "model"             sequence parallelism of the residual stream
  heads   -> "model"             tensor parallel attention
  ff      -> "model"             tensor parallel MLP
  vocab   -> "model"             vocab-parallel embedding/loss
  experts -> "model"             expert parallel (when E % axis == 0)
  kv_seq  -> "data"              sequence-parallel KV cache (long decode)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Optional

import torch

from repro_torch.distributed.mesh import (axis_positions, current_view,
                                          note_collective)

_state = threading.local()


def _active():
    return getattr(_state, "ctx", None)


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: a ``distributed.mesh.Mesh``, or anything with
    a ``shape`` mapping of axis name to size."""
    return int(math.prod(mesh.shape.values()))


def _axes(axis) -> tuple:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict):
    """Activate the logical->mesh axis mapping for model sharding
    constraints. ``mesh`` has a ``shape`` mapping (axis name -> size).
    On a mesh of more than one device every mesh axis the rules name must
    be the mesh's (``launch.mesh.activation_rules(mesh)`` gives such
    rules): a rule naming an absent axis raises ``ValueError``."""
    if _mesh_size(mesh) > 1:
        missing = sorted({a for v in rules.values() for a in _axes(v)}
                         - set(mesh.shape))
        if missing:
            raise ValueError(
                f"rules name mesh axes {missing} that the mesh "
                f"{dict(mesh.shape)} lacks; take "
                "launch.mesh.activation_rules(mesh)")
    prev = _active()
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules() -> Optional[tuple]:
    return _active()


def resolve_spec(rules: dict, *logical) -> tuple:
    """The mesh axes behind each logical name (None = replicated dim)."""
    return tuple(rules.get(name) if name else None for name in logical)


def axis_size(logical: str) -> int:
    """Mesh size behind a logical axis in the active context (1 if none)."""
    ctx = _active()
    if ctx is None:
        return 1
    mesh, rules = ctx
    return int(math.prod(mesh.shape[a] for a in _axes(rules.get(logical))))


def shard(x, *logical):
    """Constrain x's layout by logical axis names. The identity: the model
    computes on whole local tensors (one device, or one data position of
    a mesh), and the launch layer holds the layout."""
    return x


def gather_for_compute(x, *keep):
    """ZeRO-3 use-site gather of a weight's FSDP dims. The identity: a
    data position's weights are gathered whole and exact before its
    compute (``launch/steps.py``), so no bf16 partial sums are ever formed
    over a sharded contraction dimension."""
    return x


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": "model",
    "heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "data",
    "embed": "data",
}


# ---------------------------------------------------------------------------
# Data positions
# ---------------------------------------------------------------------------

class Exchange:
    """The all-gather of data positions running in lockstep threads: each
    position hands in its tensor and gets every position's, in position
    order. A position that fails aborts the others' waits. ``turns``: a
    lock each position holds while it runs, given up while it waits (the
    positions then take turns between exchanges)."""

    def __init__(self, count: int, turns: Optional[threading.Lock] = None):
        self.count = count
        self._slots = [None] * count
        self._barrier = threading.Barrier(count)
        self._turns = turns

    def all_gather(self, index: int, x) -> list:
        self._slots[index] = x
        self._wait()
        out = list(self._slots)
        self._wait()
        note_collective("all-gather", sum(t.numel() * t.element_size()
                                          for t in out), self.count)
        return out

    def _wait(self):
        """Wait for every position, giving up the turn meanwhile."""
        if self._turns is None:
            self._barrier.wait()
            return
        self._turns.release()
        try:
            self._barrier.wait()
        finally:
            self._turns.acquire()

    def abort(self):
        self._barrier.abort()


@dataclasses.dataclass
class Position:
    """One data position's share of a global batch: ``index`` of
    ``count`` (mesh order of the batch axes), its rows a contiguous
    ``1 / count`` of the global batch. ``exchange`` is set when the
    positions run in lockstep (MoE groups spanning positions); ``memo``
    keeps what a position received in its forward, for the backward's
    recomputation (rematerialised layers), which runs no exchange."""
    index: int
    count: int
    exchange: Optional[Exchange] = None
    memo: dict = dataclasses.field(default_factory=dict)


def current_position() -> Optional[Position]:
    """The data position whose compute is running on this thread (None:
    the whole batch)."""
    return getattr(_state, "position", None)


@contextlib.contextmanager
def data_position(position: Optional[Position]):
    prev = current_position()
    _state.position = position
    try:
        yield position
    finally:
        _state.position = prev


def carry_context() -> Callable:
    """A context factory that enters, on whichever thread runs it, the
    mesh rules and the data position active on this thread now. Autograd
    runs a CUDA backward, and with it the recomputation of a
    rematerialised forward, on a thread of its own, where the thread's
    own state would read no mesh and no position."""
    ctx, position = _active(), current_position()

    @contextlib.contextmanager
    def enter():
        prev = _active(), current_position()
        _state.ctx, _state.position = ctx, position
        try:
            yield
        finally:
            _state.ctx, _state.position = prev
    return enter


def run_positions(fn: Callable, count: int, lockstep: bool,
                  mesh=None, rules: Optional[dict] = None) -> list:
    """``[fn(i) for i in range(count)]``, each call under its data
    position (and ``mesh`` / ``rules`` when given). ``lockstep``: one
    thread a position, sharing an ``Exchange``; the first failure is
    raised after every thread has stopped."""
    def one(i, exchange):
        ctx = (use_mesh_rules(mesh, rules) if mesh is not None
               else contextlib.nullcontext())
        with ctx, data_position(Position(i, count, exchange)):
            return fn(i)

    if not lockstep or count == 1:
        held = held_positions(count, mesh, rules)
        if held is None:
            return [one(i, None) for i in range(count)]
        # a dry run's view: the positions it does not hold are alike
        ran = {i: one(i, None) for i in held}
        return [ran.get(i, ran[held[0]]) for i in range(count)]
    # within a dry run's view the positions take turns between exchanges:
    # sixteen threads contending for the GIL op by op run ~5x slower
    turns = threading.Lock() if current_view() is not None else None
    exchange = Exchange(count, turns)
    out: list = [None] * count
    errors: list = []
    grad = torch_grad_mode()
    modes = _dispatch_modes()

    def body(i):
        try:
            with grad(), modes(), turns or contextlib.nullcontext():
                out[i] = one(i, exchange)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((i, e))
            exchange.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the failure itself, not a peer's broken wait
        first = min(errors, key=lambda ie: (
            isinstance(ie[1], threading.BrokenBarrierError), ie[0]))
        raise first[1]
    return out


def held_positions(count: int, mesh, rules) -> Optional[list]:
    """Within ``distributed.mesh.view``: the positions (of ``count``)
    whose device is at the view's coordinates; None outside a view."""
    held = current_view()
    if held is None or mesh is None or count == 1:
        return None
    where = axis_positions(mesh, _axes((rules or {}).get("batch")))
    coords = [tuple(w.get(a, 0) for a in mesh.axis_names) for w in where]
    out = [i for i in range(count) if coords[i] == held]
    if not out:
        raise ValueError(f"the view {held} holds no data position")
    return out


def _dispatch_modes() -> Callable:
    """A context factory entering, in another thread, the dispatch modes
    active on this thread (PyTorch keeps them per thread): a dry run's
    counter sees the lockstep positions' work."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack, _pop_mode, _push_mode)
    stack = _get_current_dispatch_mode_stack()

    @contextlib.contextmanager
    def modes():
        for m in stack:
            _push_mode(m)
        try:
            yield
        finally:
            for _ in stack:
                _pop_mode()
    return modes


def torch_grad_mode() -> Callable:
    """A context factory restoring this thread's grad and inference modes
    in another thread (PyTorch keeps them per thread)."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    @contextlib.contextmanager
    def mode():
        with torch.inference_mode(inference), torch.set_grad_enabled(grad):
            yield
    return mode
