"""Parameter, cache and batch layouts: FSDP over "data" x tensor/expert
parallel storage over "model", resolved per architecture (the port's
counterpart of ``repro.launch.sharding``; its rule tables copied).

Rules are path-regex -> logical axes; logical axes resolve to mesh axes
(launch.mesh.activation_rules) with divisibility checks — a dimension that
does not divide its mesh axis falls back to replicated (exceptions: see
`_maybe`). MoE experts shard over "model" when E divides it (expert
parallelism); otherwise experts replicate and the per-expert FFN is
sharded over its hidden dim (granite's 40 experts on a 16-way axis).

The port's parameters are a flat ``state_dict`` with the layers
unstacked (``models.convert``): a name ``layers.3.mixer.wq`` is matched
as the path ``['layers'][3]['mixer']['wq']``, and the reference's
leading scan-period axis has no counterpart — a parameter's spec is the
reference's without that lead. Caches likewise: one entry a layer in
``cache["layers"]`` (and ``cache["cross"]``), no period axis.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from repro_torch.distributed.mesh import Mesh, NamedSharding
from repro_torch.distributed.mesh import PartitionSpec as P
from repro_torch.models.config import ModelConfig

# path-regex -> logical spec
PARAM_RULES = [
    (r"\['embed'\]\['table'\]$", ("vocab", "embed")),
    (r"\['lm_head'\]\['table'\]$", ("vocab", "embed")),
    (r"\['(wq|wk|wv)'\]$", ("embed", "heads")),
    (r"\['wo'\]$", ("heads", "embed")),
    (r"\['(wi_gate|wi_up)'\]$", ("embed", "ff")),          # dense MLP (D, F)
    (r"\['ffn'\]\['router'\]$", ("embed", None)),
    (r"moe_wi", ("experts", "embed", "ff")),               # (E, D, F) placeholder
    (r"\['in_proj'\]$", ("embed", "ff")),                  # mamba (D, 2di)
    (r"\['x_proj'\]$", ("ff", None)),
    (r"\['dt_proj'\]\['w'\]$", (None, "ff")),
    (r"\['dt_proj'\]\['b'\]$", ("ff",)),
    (r"\['a_log'\]$", ("ff", None)),
    (r"\['d_skip'\]$", ("ff",)),
    (r"\['out_proj'\]$", ("ff", "embed")),                 # mamba/rglru out
    (r"\['(gate_proj|rec_proj)'\]$", ("embed", "ff")),     # rglru (D, W)
    (r"\['(wa|wx)'\]$", (None, "ff")),                     # rglru (W, W)
    (r"\['lambda'\]$", ("ff",)),
    (r"\['conv'\]\['w'\]$", (None, "ff")),
    (r"\['conv'\]\['b'\]$", ("ff",)),
    (r"\['scale'\]$", (None,)),                            # norms
]


def path_of(name: str) -> str:
    """A ``state_dict`` name as the reference's key path:
    ``layers.3.mixer.wq`` -> ``['layers'][3]['mixer']['wq']``."""
    return "".join(f"[{k}]" if k.isdigit() else f"[{k!r}]"
                   for k in name.split("."))


def _logical_for(path: str, shape, cfg: ModelConfig, ep: bool):
    # MoE expert tensors are 3-D (E, D, F) / (E, F, D)
    if re.search(r"\['ffn'\]\['(wi_gate|wi_up)'\]$", path) and len(shape) >= 3:
        return ("experts", "embed", None) if ep else (None, "embed", "ff")
    if re.search(r"\['ffn'\]\['wo'\]$", path) and len(shape) >= 3:
        return ("experts", None, "embed") if ep else (None, "ff", "embed")
    for pat, spec in PARAM_RULES:
        if re.search(pat, path):
            return spec
    return tuple(None for _ in shape)


def _mesh_axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return mesh.shape[axis]


def _maybe(mesh: Mesh, rules: dict, logical, dim: int) -> Optional[object]:
    """Resolve one logical name to a mesh axis iff the dim divides it."""
    axis = rules.get(logical) if logical else None
    if axis is None:
        return None
    if dim % _mesh_axis_size(mesh, axis) != 0:
        return None
    return axis


def param_shardings(params_shape: dict, cfg: ModelConfig, mesh: Mesh,
                    rules: dict) -> dict:
    """``{name: NamedSharding}`` for a flat ``{name: tensor}`` of the
    model's parameters (meta tensors do: only the shapes are read).
    ``cfg`` None: a module without experts (``FFTConvMixer``)."""
    ep = (cfg is not None and cfg.moe is not None
          and cfg.moe.n_experts % _mesh_axis_size(mesh, rules.get("experts"))
          == 0)
    out = {}
    for name, leaf in params_shape.items():
        shape = tuple(leaf.shape)
        logical = _logical_for(path_of(name), shape, cfg, ep)
        if len(logical) != len(shape):
            logical = tuple(None for _ in shape)
        out[name] = NamedSharding(mesh, P(*[
            _maybe(mesh, rules, lg, d) for lg, d in zip(logical, shape)]))
    return out


def _flatten(tree, path=""):
    """[(path, leaf)] of a cache tree (dicts and lists), the reference's
    key-path strings."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flatten(tree[k],
                                                    f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    return [leaf for _, leaf in _flatten(tree)]


def tree_map(fn, tree):
    """``fn`` of every leaf, in the tree's structure."""
    return _unflatten(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def cache_shardings(cache_shape, cfg: ModelConfig, mesh: Mesh, rules: dict,
                    batch: int):
    """Decode-cache layouts, a tree shaped as the cache (its ``step``, an
    int, gets ``P()``). KV tensors (B, S, K, Dh): batch shards over the
    batch axes when divisible; otherwise the cache sequence shards over
    "data" (sequence-parallel flash-decoding for batch-1 long context).
    KV heads shard over "model" when divisible, else head_dim. Recurrent
    states shard their batch dim when it divides; the channel dim stays
    replicated."""
    baxes = rules.get("batch")
    b_ok = batch % _mesh_axis_size(mesh, baxes) == 0 and batch > 1
    out = []
    for pstr, leaf in _flatten(cache_shape):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = P()
        if re.search(r"\['(k|v)'\]$", pstr) and len(shape) >= 4:
            lead = len(shape) - 4
            bdim, sdim, kdim, ddim = shape[-4:]
            b_ax = baxes if (b_ok and bdim % _mesh_axis_size(mesh, baxes)
                             == 0) else None
            s_ax = None if b_ax is not None else _maybe(
                mesh, rules, "kv_seq", sdim)
            k_ax = _maybe(mesh, rules, "heads", kdim)
            d_ax = None if k_ax is not None else _maybe(
                mesh, rules, "heads", ddim)
            spec = P(*([None] * lead + [b_ax, s_ax, k_ax, d_ax]))
        elif re.search(r"\['pos'\]$", pstr) and len(shape) >= 2:
            lead = len(shape) - 2
            b_ax = baxes if (b_ok and shape[-2] % _mesh_axis_size(
                mesh, baxes) == 0) else None
            spec = P(*([None] * lead + [b_ax, None]))
        elif len(shape) >= 2:  # recurrent states (B, ...)
            axes = [None] * len(shape)
            if b_ok and shape[0] % _mesh_axis_size(mesh, baxes) == 0:
                axes[0] = baxes
            spec = P(*axes)
        out.append(NamedSharding(mesh, spec))
    return _unflatten(cache_shape, iter(out))


def batch_shardings(batch_shape: dict, mesh: Mesh, rules: dict) -> dict:
    """Input batch: dim 0 over the batch axes (if divisible), rest
    replicated."""
    baxes = rules.get("batch")

    def one(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, P())
        ok = leaf.shape[0] % _mesh_axis_size(mesh, baxes) == 0
        return NamedSharding(
            mesh, P(*([baxes if ok else None] + [None] * (leaf.ndim - 1))))

    return {k: one(v) for k, v in batch_shape.items()}


class Placed:
    """A shape, a dtype and a layout, without data (the reference's
    sharded ``ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype, sharding: NamedSharding):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard_shape(self) -> tuple:
        return self.sharding.shard_shape(self.shape)

    def __repr__(self) -> str:
        return f"Placed({list(self.shape)}, {self.dtype}, {self.sharding!r})"


def attach(shapes, shardings):
    """A tree of (meta) tensors + a matching tree of layouts -> a tree of
    ``Placed`` (no allocation)."""
    placed = [Placed(getattr(t, "shape", ()), getattr(t, "dtype", None), s)
              for t, s in zip(tree_leaves(shapes), tree_leaves(shardings))]
    return _unflatten(shapes, iter(placed))
