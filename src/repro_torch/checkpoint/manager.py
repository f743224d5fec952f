"""npz checkpoints: atomic, keep-k, async (the port's counterpart of
``repro.checkpoint.manager``).

Layout (one directory per step), the reference's:
    <dir>/step_000123/
        manifest.json        step, leaves {path: shard, key, shape, dtype},
                             shards
        shard_000.npz        leaf arrays (host numpy), chunked ~512 MB
    <dir>/step_000123.tmp_*  staging dir, os.rename'd into place (atomic on
                             POSIX within a filesystem)

A tree is nested dicts (keys in sorted order, as JAX flattens them) and
lists of tensors; a leaf's path is its keys, ``"['params']/['w']"``, as
the reference writes them. bfloat16 has no numpy dtype: such a leaf is
stored as its uint16 bits and the manifest says ``"bfloat16"``.

``save`` copies every leaf to host memory before it returns, so an async
save holds the values of the moment it was called even when training
goes on to update the tensors in place; a ``ShardedTensor`` leaf is
gathered whole first, so a checkpoint is layout-free, as the
reference's. ``restore`` puts the leaves on one device or on a tree of
devices matching ``like`` (the caller writes them into a sharded run's
slabs: ``launch.train.restore``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.mesh import ShardedTensor

_SHARD_BYTES = 512 * 1024 * 1024


def _flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts and lists, in JAX's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in
                _flatten(v, path + (f"[{i}]",))]
    return [("/".join(path), tree)]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` whose leaves, in ``_flatten``'s order,
    come from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    """A host copy of ``x`` that no later in-place write reaches."""
    if isinstance(x, ShardedTensor):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x, copy=True)


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=False))
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Write checkpoint for `step`. blocking=False returns once the
        leaves are copied to host memory and writes them on a background
        thread (training continues)."""
        flat = _flatten(tree)
        keys = [k for k, _ in flat]
        dtypes = ["bfloat16" if getattr(x, "dtype", None) == torch.bfloat16
                  else None for _, x in flat]
        host = [_to_host(x) for _, x in flat]         # device->host copy now
        if blocking:
            return self._write(step, keys, host, dtypes)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, keys, host, dtypes), daemon=True)
        self._thread.start()
        return self._final_dir(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _final_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _write(self, step: int, keys, arrays, dtypes) -> str:
        final = self._final_dir(step)
        tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp_", dir=self.dir)
        try:
            manifest = {"step": step, "leaves": {}, "shards": []}
            shard, shard_bytes, shard_idx = {}, 0, 0

            def flush():
                nonlocal shard, shard_bytes, shard_idx
                if not shard:
                    return
                fname = f"shard_{shard_idx:03d}.npz"
                np.savez(os.path.join(tmp, fname), **shard)
                manifest["shards"].append(fname)
                shard, shard_bytes, shard_idx = {}, 0, shard_idx + 1

            for i, (k, a, dt) in enumerate(zip(keys, arrays, dtypes)):
                skey = f"a{i:06d}"
                manifest["leaves"][k] = {
                    "shard": f"shard_{shard_idx:03d}.npz", "key": skey,
                    "shape": list(a.shape), "dtype": dt or str(a.dtype)}
                shard[skey] = a
                shard_bytes += a.nbytes
                if shard_bytes >= _SHARD_BYTES:
                    flush()
            flush()
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._final_dir(s), ignore_errors=True)

    # ---- restore --------------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device: Any = None) -> tuple:
        """Restore into the structure of `like` (a tree of tensors).
        Returns (tree, step).

        device: one device for every leaf, or a tree of devices matching
        `like`; None puts each leaf on the device of its `like` leaf."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._final_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        cache = {}

        def load(key):
            info = manifest["leaves"][key]
            if info["shard"] not in cache:
                cache[info["shard"]] = np.load(os.path.join(d, info["shard"]))
            return cache[info["shard"]][info["key"]], info["dtype"]

        flat = _flatten(like)
        if isinstance(device, (dict, list, tuple)):
            devices = [dv for _, dv in _flatten(device)]
        else:
            devices = [device] * len(flat)
        if len(devices) != len(flat):
            raise ValueError(f"{len(devices)} devices for {len(flat)} leaves")
        out = []
        for (k, ref), dev in zip(flat, devices):
            a, dtype = load(k)
            if list(a.shape) != list(ref.shape):
                raise ValueError(f"{k}: checkpoint shape {list(a.shape)}, "
                                 f"expected {list(ref.shape)}")
            if dev is None:
                dev = getattr(ref, "device", "cpu")
            out.append(_from_host(a, dtype, dev))
        return _unflatten(like, iter(out)), step
