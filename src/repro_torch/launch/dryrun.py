"""Dry run: every (arch x shape) cell on the production meshes, on meta
tensors, through the port's own step code; per device, what it holds,
the least time its step can take, and which term bounds it.

The port's counterpart of ``repro.launch.dryrun``. Where the reference
lowers and compiles each cell for 512 placeholder XLA devices and reads
``memory_analysis()`` and ``cost_analysis()``, the port builds the cell
through its normal entry points (``launch/steps.py`` over
``launch/mesh.py``'s meshes, laid out by ``launch/sharding.py`` from
``launch/specs.py``'s meta specs) and runs one step under
``launch/counting.py``'s ``MetaCounter``:

- ``argument_bytes``: the slabs and batch rows a device holds on entry
  (``NamedSharding.shard_shape``);
- ``temp_bytes``: the high-water mark of the bytes the step makes on
  that device and still holds; ``peak_bytes_per_device`` their sum;
- the roofline (``launch/roofline.py``) of that device's FLOPs, HBM
  bytes and collectives, at the H100's rates.

The terms are the busiest device's, named in the record (``device``).
Each data position runs as ranks, one a device of its "model" row,
splitting its compute as the reference's layout does
(``models/sharding.py``), so the compute term is one rank's.

Data positions run the same code on same-shaped rows, and a position's
ranks alike, so a step is traced once: under ``distributed.mesh.view``
of the first position's device, that position's rank there runs (the
others' results are its results; a collective has no peers and makes
the shape its group would, counted from its shapes), and the gathers,
the reductions of every position's gradients into the device's slabs
and AdamW over them are counted in full. An MoE group spanning positions
still runs every position's rank, in lockstep.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --arch sar-rda-4k --mesh multi
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed.mesh import sharded_empty
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs, steps
from repro_torch.launch.counting import MetaCounter
from repro_torch.launch.mesh import activation_rules, make_production_mesh
from repro_torch.models import Model

_META = torch.device("meta")


def _flops_train(cfg, shape) -> float:
    """Analytic MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens."""
    n = cfg.active_param_count()
    return 6.0 * n * shape.global_batch * shape.seq_len


def _flops_decode(cfg, shape) -> float:
    return 2.0 * cfg.active_param_count() * shape.global_batch


def _flops_prefill(cfg, shape) -> float:
    return (2.0 * cfg.active_param_count()
            * shape.global_batch * shape.seq_len)


def model_flops(arch: str, shape_name: str) -> float:
    """The record's analytic ``model_flops`` (global, all devices)."""
    if arch.startswith("sar-rda"):
        n = 8192 if "8k" in arch else 4096
        return _flops_sar(n, n)
    shape = registry.SHAPES[shape_name]
    cfg = registry.get(arch)
    if shape.kind == "train":
        return _flops_train(cfg, shape)
    if shape.kind == "prefill":
        return _flops_prefill(cfg, shape)
    return _flops_decode(cfg, shape)


def _flops_sar(na: int, nr: int) -> float:
    # 2 FFT-ish passes * 5 N log N per point + filters
    n_pts = na * nr
    return (2 * 5 * n_pts * math.log2(nr) + 2 * 5 * n_pts * math.log2(na)
            + 3 * 6 * n_pts)


def _placed_bytes(placed) -> int:
    """Bytes one device holds of a tree of ``sharding.Placed``."""
    total = 0
    for p in shd.tree_leaves(placed):
        if isinstance(p, shd.Placed) and p.dtype is not None:
            total += math.prod(p.shard_shape()) * \
                torch.empty((), dtype=p.dtype).element_size()
    return total


def _laid_out(shapes, shardings):
    """Meta ``ShardedTensor``s of a tree of meta specs in the layouts of
    the matching tree of ``NamedSharding``s (non-tensors kept)."""
    leaves = [sharded_empty(t.shape, s, t.dtype)
              if isinstance(t, torch.Tensor) else t
              for t, s in zip(shd.tree_leaves(shapes),
                              shd.tree_leaves(shardings))]
    it = iter(leaves)
    return shd.tree_map(lambda _: next(it), shapes)


def _cell(cfg, shape, mesh, rules):
    """The cell's step on meta: (step callable, its arguments, the bytes
    one device holds of them)."""
    model = Model(cfg, device=_META)
    p_shape = specs.params_specs(model)
    p_shard = shd.param_shardings(p_shape, cfg, mesh, rules)
    params = {n: sharded_empty(t.shape, p_shard[n], t.dtype)
              for n, t in p_shape.items()}
    held = _placed_bytes(shd.attach(p_shape, p_shard))
    if shape.kind == "train":
        opt = steps.init_sharded_opt(params)
        batch = specs.batch_specs(cfg, shape, with_labels=True)
        held = 3 * held + 4 + _placed_bytes(shd.attach(
            batch, shd.batch_shardings(batch, mesh, rules)))
        fn = steps.build_train_step(model, mesh=mesh, rules=rules,
                                    params=params)
        return fn, (opt, batch), held, params
    if shape.kind == "prefill":
        batch = specs.batch_specs(cfg, shape, with_labels=False)
        held += _placed_bytes(shd.attach(
            batch, shd.batch_shardings(batch, mesh, rules)))
        fn = steps.build_prefill(model, max_len=shape.seq_len, mesh=mesh,
                                 rules=rules, params=params)
        return fn, (batch,), held, params
    c_shape = specs.cache_specs(model, shape)
    c_shard = shd.cache_shardings(c_shape, cfg, mesh, rules,
                                  shape.global_batch)
    cache = _laid_out(c_shape, c_shard)
    tokens = specs.decode_token_specs(shape)
    # + the cache's position: a host int in the port, where the reference
    # holds an int32 on every device, counted as that
    held += 4 + _placed_bytes(shd.attach(c_shape, c_shard)) + _placed_bytes(
        shd.attach(tokens, shd.batch_shardings({"t": tokens}, mesh,
                                               rules)["t"]))
    fn = steps.build_decode(model, mesh=mesh, rules=rules, params=params)
    return fn, (cache, tokens), held, params


def count_step(fn, args, mesh=None, rules=None, placed=()):
    """Run ``fn(*args)`` once on meta under a ``MetaCounter`` (over
    ``mesh``: viewing the first data position's device; ``placed``, more
    arguments the step holds, such as its weights); returns (counter,
    output, seconds)."""
    counter = MetaCounter(mesh, rules)
    counter.place((args, placed))
    view = (meshlib.view(counter.home) if mesh is not None
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with counter, view:
        out = fn(*args)
    return counter, out, time.perf_counter() - t0


def _trace(counter: MetaCounter, at: tuple) -> dict:
    dev = counter.devices[at]
    return {"device": list(at), "flops": dev.flops,
            "hbm_bytes": dev.hbm_bytes, "temp_bytes": dev.peak,
            "launches": dev.launches,
            "ops": {k: list(v) for k, v in sorted(dev.ops.items())},
            "collectives": [list(c) for c in dev.collectives]}


def _save_trace(record: dict, trace: dict, out_dir, name: str):
    """Persist the busiest device's per-op counts and collectives
    (gzipped JSON) so the roofline can be re-priced without a re-trace."""
    if not out_dir:
        return
    path = os.path.join(out_dir, name + ".trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    record["trace"] = os.path.basename(path)


def _finish(record: dict, counter: MetaCounter, out, argument_bytes: int,
            n_dev: int, out_dir, name: str) -> dict:
    at = counter.busiest()
    dev = counter.devices[at]
    record["device"] = list(at)
    record["memory"] = {
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(counter.created(out, at)),
        "temp_bytes": int(dev.peak),
        "peak_bytes_per_device": int(argument_bytes + dev.peak),
    }
    record["launches"] = dict(dev.launches)
    _save_trace(record, _trace(counter, at), out_dir, name)
    # model_flops is global; divide by chips to compare per device
    roof = dev.roofline(record["model_flops"] / n_dev)
    record["roofline"] = roof.to_dict()
    return record


def lower_cell(arch: str, shape_name: str, mesh, out_dir=None, name=None,
               cached_correction=None) -> dict:
    """Count one cell's step on meta; returns the record dict."""
    del cached_correction    # the port unrolls its layers: nothing to fix
    rules = activation_rules(mesh)
    n_dev = mesh.devices.size
    record = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(str(s) for s in mesh.devices.shape),
              "devices": int(n_dev)}
    record["model_flops"] = model_flops(arch, shape_name)
    if arch.startswith("sar-rda"):
        return _lower_sar(record, mesh, out_dir, name)
    shape = registry.SHAPES[shape_name]
    cfg = registry.get(arch)

    t0 = time.time()
    fn, args, held, params = _cell(cfg, shape, mesh, rules)
    counter, out, _ = count_step(fn, args, mesh, rules, params)
    record["t_lower_s"] = round(time.time() - t0, 2)
    # the reference adds the FLOPs XLA's cost analysis misses in a scan
    # body; the port runs every layer unrolled, so every FLOP is counted
    record["scan_flops_correction_per_device"] = 0.0
    return _finish(record, counter, out, held, n_dev, out_dir,
                   name or f"{arch}__{shape_name}")


def _lower_sar(record: dict, mesh, out_dir=None, name=None) -> dict:
    """The paper's own workload on the production mesh: distributed RDA
    (corner-turn schedule), all mesh axes pooled, the raw scene on the
    first device. Each spectral launch is priced on meta by
    ``tuning/cost.py``. `sar-rda-8k` is the paper's future-work target."""
    from repro_torch.core.sar import paper_scene
    from repro_torch.core.sar.distributed import build_corner2

    n = 8192 if "8k" in record["arch"] else 4096
    cfg = paper_scene(na=n, nr=n)
    axes = tuple(mesh.axis_names)
    t0 = time.time()
    run = build_corner2(cfg, mesh, axes=axes, block=8, col_block=8)
    raw = torch.empty((cfg.na, cfg.nr), dtype=torch.complex64, device=_META)
    counter, out, _ = count_step(run, (raw,), mesh, None)
    record["t_lower_s"] = round(time.time() - t0, 2)
    record["scan_flops_correction_per_device"] = 0.0
    held = raw.numel() * raw.element_size()
    return _finish(record, counter, out, held, mesh.devices.size, out_dir,
                   name or record["arch"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--refresh", action="store_true",
                    help="recompute existing cells")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    cells = []
    if args.all:
        cells = [(a, s) for a, s, skip in registry.cells() if skip is None]
        cells.append(("sar-rda-4k", "n/a"))
    else:
        assert args.arch, "--arch or --all required"
        if args.arch.startswith("sar"):
            cells = [(args.arch, "n/a")]
        else:
            cells = [(args.arch, args.shape or "train_4k")]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for multi in meshes[args.mesh]:
        mesh = make_production_mesh(multi_pod=multi)
        tag = "multi" if multi else "single"
        for arch, shape in cells:
            name = f"{arch}__{shape}__{tag}".replace("/", "_")
            path = os.path.join(args.out, name + ".json")
            if os.path.exists(path) and not args.refresh:
                with open(path) as f:
                    if "roofline" in json.load(f):
                        print(f"SKIP {name} (exists)")
                        continue
            try:
                rec = lower_cell(arch, shape, mesh, args.out, name)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                print(f"OK   {name}: trace={rec['t_lower_s']}s "
                      f"mem={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
                      f"t_comp={r['t_compute_s']*1e3:.2f}ms "
                      f"t_mem={r['t_memory_s']*1e3:.2f}ms "
                      f"t_coll={r['t_collective_s']*1e3:.2f}ms "
                      f"bound={r['bottleneck']}", flush=True)
            except Exception as e:  # noqa: BLE001 - counted, exit code 1
                failures += 1
                print(f"FAIL {name}: {e}", flush=True)
                traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
