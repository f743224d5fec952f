"""A single-process device mesh and its three collectives.

The port's counterpart of what JAX itself gives the reference
(``jax.sharding.Mesh`` and ``jax.lax.all_to_all`` / ``ppermute`` /
``all_gather`` under ``shard_map``): one process drives every device of
the mesh, a sharded tensor is a list of per-device slabs (one tensor per
mesh position, in mesh order), and a collective is a set of copies
between those slabs — ``Tensor.to`` / ``narrow`` / ``torch.cat``, peer
copies over NVLink between cards, plain copies on one device.

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

from typing import Sequence, Union

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
        along ``axes``. Every mesh axis of more than one device must be
        among them: a slab replicated over an unnamed axis is not
        supported."""
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
                    "replicated over a mesh axis are not supported")
            order = [self.axis_names.index(a) for a in _as_axes(axes)]
            rest = [i for i in range(self.devices.ndim) if i not in order]
            devs = np.transpose(self.devices, order + rest)
        else:
            devs = self.devices
        return list(devs.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def shard(x: torch.Tensor, axis: int, devices: Sequence) -> list:
    """``x`` cut into ``len(devices)`` equal slabs along ``axis``, slab i
    contiguous on ``devices[i]``."""
    p = len(devices)
    n = x.shape[axis]
    if n % p:
        raise ValueError(f"{n} lines along axis {axis} not divisible by "
                         f"{p} devices")
    c = n // p
    return [x.narrow(axis, i * c, c).contiguous().to(d)
            for i, d in enumerate(devices)]


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
        out.append(torch.cat([s.narrow(split_axis, j * c, c).to(dst)
                              for s in slabs], dim=concat_axis))
    return out


def ppermute(slabs: Sequence[torch.Tensor], perm) -> list:
    """``perm`` is a list of ``(source, destination)`` pairs: destination
    d gets source s's slab on its own device; a device no pair names as a
    destination gets zeros, as ``jax.lax.ppermute`` gives it."""
    out = [torch.zeros_like(s) for s in slabs]
    dests = set()
    for src, dst in perm:
        if dst in dests:
            raise ValueError(f"device {dst} is the destination of two pairs")
        dests.add(dst)
        out[dst] = slabs[src].to(slabs[dst].device)
    return out


def all_gather(slabs: Sequence[torch.Tensor], axis: int) -> list:
    """The tiled all-gather: every device gets every slab, concatenated
    in mesh order along ``axis``, on its own device."""
    return [unshard(slabs, axis, s.device) for s in slabs]
