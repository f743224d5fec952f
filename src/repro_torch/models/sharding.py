"""Logical-axis sharding constraints for model code.

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "heads")``). A launch-layer context maps
logical names to mesh axes; outside any context the calls are identity,
so unit tests and single-card runs are unaffected.

This slice runs the model on one device: a context may be entered with a
mesh of one device (every call stays the identity, as the reference's
constraints are on one device), and a mesh of more than one device raises
``NotImplementedError`` — the multi-device model layout comes with the
launch slice (``launch/mesh.py``, ``launch/sharding.py``).

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
import math
import threading
from typing import Optional

_state = threading.local()


def _active():
    return getattr(_state, "ctx", None)


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: a ``distributed.mesh.Mesh``, or anything with
    a ``shape`` mapping of axis name to size."""
    return int(math.prod(mesh.shape.values()))


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict):
    """Activate the logical->mesh axis mapping for model sharding
    constraints. ``mesh`` has a ``shape`` mapping (axis name -> size)."""
    if _mesh_size(mesh) > 1:
        raise NotImplementedError(
            "the model runs on one device in this port: a mesh of "
            f"{_mesh_size(mesh)} devices needs the launch slice "
            "(launch/mesh.py, launch/sharding.py)")
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
    axis = rules.get(logical)
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(math.prod(mesh.shape[a] for a in axes))


def shard(x, *logical):
    """Constrain x's layout by logical axis names: on one device, identity."""
    return x


def gather_for_compute(x, *keep):
    """ZeRO-3 use-site gather of a weight's FSDP dims: on one device,
    identity (every dim is whole)."""
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
