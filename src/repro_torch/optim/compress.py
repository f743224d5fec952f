"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (the port's counterpart of ``repro.optim.compress``).

Each gradient is quantized to int8 with one float32 scale per tensor;
the quantization residual is kept locally and added to the next step's
gradient (error feedback: the residual is delayed, never lost).

``compressed_psum`` runs over the port's single-process mesh
(``distributed.mesh.Mesh``): one gradient tree and one error tree for
each slab of the named axis, each slab quantized on its own device, the
dequantized slabs summed in mesh order as copies to one device. Trees are
flat dicts ``{name: tensor}``, as ``optim.adamw`` takes them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.mesh import Mesh


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q int8, scale float32 0-d).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads: Sequence[dict], error: Sequence[dict],
                    mesh: Mesh, axis_name: str):
    """All-reduce-mean per-slab gradients in int8 with error feedback.

    grads / error: one tree of float32 gradients / residuals a slab of
    ``axis_name``, in mesh order, each on its slab's device. Returns
    (mean, new_error): the mean tree on every slab's device, and each
    slab's new residual."""
    devices = mesh.device_list(axis_name)
    n = len(devices)
    if len(grads) != n or len(error) != n:
        raise ValueError(f"{len(grads)} gradient and {len(error)} error "
                         f"trees for {n} slabs of axis {axis_name!r}")
    means = [{} for _ in range(n)]
    new_err = [{} for _ in range(n)]
    for name in grads[0]:
        deq = []
        for i in range(n):
            x = grads[i][name].to(torch.float32) + error[i][name]
            q, scale = quantize_int8(x)
            d = dequantize_int8(q, scale)
            new_err[i][name] = x - d
            deq.append(d)
        # the int8 payload summed as float32 after each slab's dequant
        # models the compressed wire format (int8 + one float32 scale)
        total = deq[0]
        for d in deq[1:]:
            total = total + d.to(total.device)
        mean = total / n
        for i, dev in enumerate(devices):
            means[i][name] = mean.to(dev)
    return means, new_err


def init_error(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compressed_bytes(params: dict) -> int:
    """Wire bytes per all-reduce hop with int8 + a per-tensor scale."""
    return sum(p.numel() + 4 for p in params.values())
