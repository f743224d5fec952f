"""``launch/dryrun.py`` and ``launch/counting.py``: the dry run's counts on
meta tensors, held to the reference's ``repro.launch.dryrun`` where they
mean the same thing, and to what the port's step code does.

The reference compiles its smoke cells once for the module, in a
subprocess (``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 devices at
import, so it is never imported here), on a (4, 2) mesh of the first 8
devices with Auto axes (under JAX 0.9.0, ``jax.make_mesh``'s default
Explicit axes make its ``with_sharding_constraint`` raise), and prints
each cell's ``argument_size_in_bytes`` and every cell's ``model_flops``.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.sar import paper_scene
from repro_torch.core.sar.distributed import build_corner2
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels.fft4step import FILTER_NONE
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as lm
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs
from repro_torch.launch.counting import MetaCounter
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.tuning import cost

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
ARCHS = ("stablelm-1.6b", "granite-moe-3b-a800m", "falcon-mamba-7b")
KINDS = ("train", "prefill", "decode")

REFERENCE = r"""
import json, math
import jax
from repro import compat
from repro.configs import registry
from repro.core.sar import paper_scene
from repro.launch import dryrun as D
from repro.launch.mesh import activation_rules

mesh = compat.make_mesh((4, 2), ("data", "model"),
                        axis_types=(compat.AXIS_TYPE_AUTO,) * 2,
                        devices=jax.devices()[:8])
rules = activation_rules(mesh)
out = {"args": {}, "model_flops": {}}
for arch in ARCHS:
    cfg = registry.smoke(arch)
    for kind in ("train", "prefill", "decode"):
        shape = registry.ShapeSpec(kind, 64, 8, kind)
        mem = D._cell_lowered(cfg, shape, mesh, rules).compile() \
            .memory_analysis()
        out["args"][arch + "/" + kind] = int(mem.argument_size_in_bytes)
for arch, sname, _ in registry.cells():
    cfg, shape = registry.get(arch), registry.SHAPES[sname]
    if shape.kind == "train":
        f = D._flops_train(cfg, shape)
    elif shape.kind == "prefill":
        f = (2.0 * cfg.active_param_count() * shape.global_batch
             * shape.seq_len)
    else:
        f = D._flops_decode(cfg, shape)
    out["model_flops"][arch + "/" + sname] = f
# _lower_sar's expression, on the reference's scene
cfg = paper_scene(na=4096, nr=4096)
n_pts = cfg.na * cfg.nr
out["model_flops"]["sar-rda-4k/n/a"] = (
    2 * 5 * n_pts * math.log2(cfg.nr) + 2 * 5 * n_pts * math.log2(cfg.na)
    + 3 * 6 * n_pts)
print("REFERENCE_JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = f"ARCHS = {ARCHS!r}\n" + REFERENCE
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(v for v in r.stdout.splitlines()
                if v.startswith("REFERENCE_JSON"))
    return json.loads(line[len("REFERENCE_JSON"):])


def host_mesh():
    return lm.make_host_mesh(2, [META] * 8)


def pod_mesh():
    devs = np.empty((2, 2, 2), dtype=object)
    devs[...] = META
    return Mesh(devs, ("pod", "data", "model"))


def smoke_cell(arch, kind, mesh):
    rules = lm.activation_rules(mesh)
    shape = registry.ShapeSpec(kind, 64, 8, kind)
    fn, args, held, params = dryrun._cell(registry.smoke(arch), shape, mesh,
                                          rules)
    return fn, args, held, params, rules


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_are_the_references(ref, arch, kind):
    held = smoke_cell(arch, kind, host_mesh())[2]
    assert held == ref["args"][f"{arch}/{kind}"]


def test_model_flops_are_the_references_for_every_cell(ref):
    cells = [(a, s) for a, s, skip in registry.cells() if skip is None]
    cells.append(("sar-rda-4k", "n/a"))
    assert len(cells) == 34
    got = {f"{a}/{s}": dryrun.model_flops(a, s) for a, s in cells}
    assert got == ref["model_flops"]


def test_counted_flops_equal_the_analytic_count():
    """stablelm's smoke config (dense, remat off) on one device: every
    projection's 2 m n k and the attention scores (QK^T and AV over the
    whole S x S, as the code forms them), x 3 with the backward; the
    loss's logits x 4, each chunk being recomputed in the backward."""
    cfg = registry.smoke("stablelm-1.6b")
    assert not cfg.remat and cfg.moe is None
    b, s = 8, 64
    model = Model(cfg, device=META)
    params = dict(model.named_parameters())
    batch = specs.batch_specs(cfg, registry.ShapeSpec("t", s, b, "train"),
                              with_labels=True)
    counter, _, _ = dryrun.count_step(steps.build_train_step(model),
                                      (adamw.init(params), batch))
    t, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    layer = (2 * t * d * (h + 2 * k) * dh + 2 * t * h * dh * d
             + 3 * 2 * t * d * f + 2 * 2 * b * h * s * s * dh)
    want = 3 * cfg.n_layers * layer + 4 * 2 * t * d * v
    assert counter.devices[()].flops == want


def full_and_viewed(arch, kind, mesh):
    """A smoke cell's step counted on every device (no view), and again
    through the dry run's view of the first position's device; and, for
    a train step, the global norm's work alone (``sq_sum`` of one copy of
    each slab, on the device holding the first copy)."""
    fn, args, _, params, rules = smoke_cell(arch, kind, mesh)
    full = MetaCounter(mesh, rules)
    full.place((args, params))
    with full:
        out = fn(*args)
    full.logits = None if kind == "train" else out[1 if kind == "prefill"
                                                   else 0]
    norm = MetaCounter(mesh, rules)
    norm.place(params)
    if kind == "train":
        with norm:
            for st in params.values():
                st.sq_sum()
    fn, args, _, params, rules = smoke_cell(arch, kind, mesh)
    viewed, _, _ = dryrun.count_step(fn, args, mesh, rules, params)
    return full, viewed, norm


def assert_same(a: dict, b: dict, extra_bytes: float = 0.0):
    """Equal counts, but for ``extra_bytes`` of traffic ``a`` makes over
    ``b``, up to the first device's scalar sums (the loss shares, the
    norm's partial sums): a few kilobytes."""
    assert a["hbm_bytes"] == pytest.approx(b["hbm_bytes"] + extra_bytes,
                                           abs=4096)
    assert {k: v for k, v in a.items() if k != "hbm_bytes"} == \
        {k: v for k, v in b.items() if k != "hbm_bytes"}


@pytest.mark.parametrize("arch,kind,mesh", [
    ("stablelm-1.6b", "train", "4x2"),
    ("stablelm-1.6b", "train", "2x2x2"),
    ("falcon-mamba-7b", "prefill", "4x2"),
    ("granite-moe-3b-a800m", "decode", "4x2"),
])
def test_every_data_position_counts_alike(arch, kind, mesh):
    mesh = host_mesh() if mesh == "4x2" else pod_mesh()
    full, viewed, norm = full_and_viewed(arch, kind, mesh)
    positions = full._positions
    assert len(positions) == 4
    home = positions[0]
    first = full.devices[home].summary()
    assert first["flops"] > 0
    for at in positions[1:]:
        # the first device also sums the squares of the first copies, and
        # puts the positions' logits together
        extra = norm.devices[home].hbm_bytes - norm.devices[at].hbm_bytes
        if full.logits is not None:
            extra += 2 * full.logits.numel() * full.logits.element_size()
        assert_same(first, full.devices[at].summary(), extra)
    # the dry run's one traced position is the full run's first device
    assert_same(viewed.devices[viewed.home].summary(), first)
    assert viewed.busiest() == viewed.home


def test_collective_bytes_are_the_slabs_the_step_moves():
    """On an (8, 1) mesh, where a position runs whole, the collectives are
    the weights' gathers and the gradients' reductions alone (the split
    over "model": ``tests/test_torch_tensor_parallel.py``)."""
    mesh = lm.make_host_mesh(1, [META] * 8)
    fn, args, _, params, rules = smoke_cell("stablelm-1.6b", "train", mesh)
    counter, _, _ = dryrun.count_step(fn, args, mesh, rules, params)
    want = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for st in params.values():
        n = math.prod(st.shape)
        if math.prod(st.sharding.parts(len(st.shape))) > 1:
            want["all-gather"] += 4 * n          # the gathered weight
        cut = any(e is not None and "data" in ((e,) if isinstance(e, str)
                                                else e) for e in st.spec)
        slab = 4 * math.prod(st.sharding.shard_shape(st.shape))
        want["reduce-scatter" if cut else "all-reduce"] += slab
    stats = rf.collective_stats(counter.devices[counter.home].collectives)
    assert stats.bytes_by_op == {k: v for k, v in want.items() if v}
    assert stats.total_bytes == sum(want.values())


def test_the_sar_cell_prices_three_launches_and_two_turns_a_device():
    mesh = Mesh(np.array([META] * 8, dtype=object), ("data",))
    n = 4096
    run = build_corner2(paper_scene(n, n), mesh, axes=("data",), block=8,
                        col_block=8)
    raw = torch.empty((n, n), dtype=torch.complex64, device=META)
    before = ops.SPECTRAL_LAUNCHES
    counter, image, _ = dryrun.count_step(run, (raw,), mesh)
    assert image.shape == (n, n) and image.device == META
    assert ops.SPECTRAL_LAUNCHES == before     # no kernel count on meta
    turn = cost.collective_turn_bytes(n, n, 1, 8)
    for i in range(8):
        dev = counter.devices[(i,)]
        assert dev.launches == {"spectral": 3}
        stats = rf.collective_stats(dev.collectives)
        assert stats.counts == {"all-to-all": 4}       # 2 turns x re, im
        assert stats.link_bytes == 2 * turn
    rec = dryrun.lower_cell("sar-rda-4k", "n/a", mesh)
    assert rec["launches"] == {"spectral": 3}
    assert rec["memory"]["argument_bytes"] == 8 * n * n
    assert rec["roofline"]["collective_link_bytes"] == 2 * turn


def test_a_meta_tensor_outside_a_dry_run_still_raises():
    x = torch.empty((8, 64), device=META)
    with pytest.raises(ValueError, match="meta"):
        ops.spectral_op(x, x)
    y = torch.empty((16, 16), device=META)
    segments = ((1, True, False, FILTER_NONE), (0, True, True, FILTER_NONE))
    with pytest.raises(ValueError, match="meta"):
        ops.mega_spectral_op(y, y, segments=segments)
    # inside one, both wrappers give the kernel's shapes and tell the
    # counter, which prices the launch; nothing counts as launched
    before = (ops.SPECTRAL_LAUNCHES, dict(ops.MEGA_LAUNCHES))
    with MetaCounter() as counter:
        out = ops.spectral_op(x, x)
        img = ops.mega_spectral_op(y, y, segments=segments)
    assert [t.shape for t in out + img] == [x.shape] * 2 + [y.shape] * 2
    assert counter.devices[()].launches == {"spectral": 1,
                                            "mega_resident": 1}
    assert counter.devices[()].flops > 0
    assert (ops.SPECTRAL_LAUNCHES, ops.MEGA_LAUNCHES) == before


def test_a_full_width_cell_makes_a_whole_record(tmp_path):
    mesh = lm.make_production_mesh()
    rec = dryrun.lower_cell("stablelm-1.6b", "decode_32k", mesh,
                            str(tmp_path), "cell")
    assert set(rec) == {"arch", "shape", "mesh", "devices", "model_flops",
                        "t_lower_s", "scan_flops_correction_per_device",
                        "device", "memory", "launches", "trace", "roofline"}
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == \
        mem["argument_bytes"] + mem["temp_bytes"] > 0
    roof = rec["roofline"]
    assert list(roof) == list(rf.from_counts(0, 0, []).to_dict())
    assert roof["model_flops"] == rec["model_flops"] / 256
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["collective_counts"]["all-gather"] > 0
    assert (tmp_path / rec["trace"]).exists()
