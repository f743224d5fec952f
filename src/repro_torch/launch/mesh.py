"""Production and host meshes (the port's counterpart of
``repro.launch.mesh``).

Single pod: (16, 16) = 256 devices, axes ("data", "model").
Multi pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model") —
the batch is cut over ("pod", "data"); parameters are FSDP over "data"
and replicated across pods; "model" shards storage (tensor-parallel
compute over it is not part of this port yet).

A production mesh is made of ``torch.device("meta")``: it lays out
shapes and allocates nothing. A host mesh is the CUDA cards this host
offers, or the devices the caller names (``[torch.device("cpu")] * 8``
here; ``[torch.device("cuda", 0)] * 8`` runs eight slabs on one card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices[...] = torch.device("meta")
    return Mesh(devices, axes)


def make_host_mesh(model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh of ``devices`` (every visible CUDA card when
    None, raising without one), ``model`` devices a data row."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: make_host_mesh takes the host's cards by "
                "default; pass devices=[torch.device('cpu')] * n to lay the "
                "mesh out on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) % model:
        raise ValueError(f"{len(devices)} devices do not divide into rows "
                         f"of {model}")
    grid = np.empty((len(devices) // model, model), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model, i % model] = d
    return Mesh(grid, ("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def activation_rules(mesh) -> dict:
    """Logical->mesh mapping for models.sharding.use_mesh_rules."""
    return {
        "batch": batch_axes(mesh),
        "seq": "model",       # Megatron-style sequence parallelism
        "heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "kv_seq": "data",     # sequence-parallel KV cache (long decode)
        "embed": "data",      # FSDP: parameters shard their d_model dim over
                              # "data" (gathered per layer, ZeRO-3 style)
    }
