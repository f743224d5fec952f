"""The port's multi-device layouts against the reference's:
``launch/sharding.py``'s parameter, cache and batch specs, ``launch/mesh.py``'s
rules and meshes, ``launch/specs.py``'s meta specs, and the mesh module's
``NamedSharding`` / ``ShardedTensor``.

The reference runs once for the module, in a subprocess with 512
placeholder devices (``XLA_FLAGS``, as ``repro.launch.dryrun`` does), on
its single-pod (16, 16), multi-pod (2, 16, 16) and a host (4, 2) mesh of
the first 8 of them, for every architecture at full width (shapes only:
``eval_shape``), and prints every leaf's shape, dtype and spec as JSON.
The reference's scan-stacked leaves carry a leading period axis, which
the port's unstacked layers do not: period p, sub-layer j is the port's
layer p * len(pattern) + j, and its spec is the reference's without the
lead.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P
from repro_torch.launch import mesh as lm
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs
from repro_torch.models import Model, sharding

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
MESHES = ("single", "multi", "host")
CACHE_SHAPES = ("decode_32k", "long_500k")

REFERENCE = r"""
import json
import jax
from repro.configs import registry
from repro.launch import sharding as shd, specs
from repro.launch.mesh import activation_rules, make_production_mesh
from repro.models import Model
from repro.models.sharding import DEFAULT_RULES

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def leaves(tree, shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sh = jax.tree_util.tree_leaves(shardings)
    return {jax.tree_util.keystr(p): [list(x.shape), str(x.dtype), spec(s)]
            for (p, x), s in zip(flat, sh)}

host = jax.make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
meshes = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True), "host": host}
cells = {(a, s) for a, s, _ in registry.cells()}
out = {"default_rules": DEFAULT_RULES, "meshes": {}}
for name, mesh in meshes.items():
    rules = activation_rules(mesh)
    m = out["meshes"][name] = {"rules": rules, "shape": dict(mesh.shape),
                               "archs": {}}
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        model = Model(cfg)
        p = specs.params_specs(model)
        rec = {"params": leaves(p, shd.param_shardings(p, cfg, mesh, rules)),
               "cache": {}, "batch": {}}
        for sname in ("decode_32k", "long_500k"):
            if (arch, sname) not in cells:
                continue
            shape = registry.SHAPES[sname]
            c = specs.cache_specs(model, shape)
            rec["cache"][sname] = leaves(c, shd.cache_shardings(
                c, cfg, mesh, rules, shape.global_batch))
        for sname, shape in registry.SHAPES.items():
            b = specs.batch_specs(cfg, shape, shape.kind == "train")
            b["decode_tokens"] = specs.decode_token_specs(shape)
            rec["batch"][sname] = leaves(b, shd.batch_shardings(b, mesh,
                                                                rules))
        m["archs"][arch] = rec
print("REFERENCE_JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(v for v in r.stdout.splitlines()
                if v.startswith("REFERENCE_JSON"))
    return json.loads(line[len("REFERENCE_JSON"):])


def port_mesh(name):
    if name == "single":
        return lm.make_production_mesh()
    if name == "multi":
        return lm.make_production_mesh(multi_pod=True)
    return lm.make_host_mesh(2, [CPU] * 8)


def as_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def trim(entries, n):
    """A spec as a list of ``n`` entries (trailing whole dims spelled
    out; an entry of one axis, which the reference's specs print as the
    axis or as a list of it, as the axis)."""
    out = [e[0] if isinstance(e, list) and len(e) == 1 else e
           for e in entries]
    return out + [None] * (n - len(out))


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def keys(path):
    return [a if a else int(b) for a, b in _KEY.findall(path)]


def port_param_name(cfg, path):
    """(port name, period index or None) of a reference parameter path."""
    k = keys(path)
    per = len(cfg.pattern)
    n_body = cfg.n_periods * per
    if k[0] == "scan":
        j = int(k[1][3:])
        return [(f"layers.{p * per + j}." + ".".join(map(str, k[2:])), p)
                for p in range(cfg.n_periods)]
    if k[0] == "rem":
        return [(f"layers.{n_body + k[1]}." + ".".join(map(str, k[2:])),
                 None)]
    return [(".".join(map(str, k)), None)]


def port_cache_path(cfg, path):
    """[(port cache path, period or None)] of a reference cache path."""
    k = keys(path)
    per = len(cfg.pattern)
    n_body = cfg.n_periods * per
    rest = "".join(f"[{v!r}]" if isinstance(v, str) else f"[{v}]"
                   for v in k[2:] if k[0] in ("scan", "scan_cross")) \
        if k[0] in ("scan", "scan_cross") else None
    if k[0] in ("scan", "scan_cross"):
        j = int(k[1][3:])
        top = "layers" if k[0] == "scan" else "cross"
        return [(f"['{top}'][{p * per + j}]{rest}", p)
                for p in range(cfg.n_periods)]
    if k[0] == "step":
        return [("['step']", None)]
    m = re.fullmatch(r"(layer|rem)(\d+)(_cross)?", k[0])
    idx = int(m.group(2)) + (n_body if m.group(1) == "rem" else 0)
    top = "cross" if m.group(3) else "layers"
    tail = "".join(f"[{v!r}]" if isinstance(v, str) else f"[{v}]"
                   for v in k[1:])
    return [(f"['{top}'][{idx}]{tail}", None)]


def port_leaves(tree, layout):
    return {p: (tuple(getattr(t, "shape", ())), t, s.spec) for (p, t), (_, s)
            in zip(shd._flatten(tree), shd._flatten(layout))}


@pytest.mark.parametrize("mesh_name", MESHES)
def test_rules_and_meshes_match_reference(ref, mesh_name):
    mesh = port_mesh(mesh_name)
    want = ref["meshes"][mesh_name]
    assert dict(mesh.shape) == want["shape"]
    got = lm.activation_rules(mesh)
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in got.items()} == want["rules"]
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in sharding.DEFAULT_RULES.items()} == \
        ref["default_rules"]
    if mesh_name != "host":
        assert {d.type for d in mesh.devices.flat} == {"meta"}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_param_specs_match_reference(ref, mesh_name, arch):
    """Every parameter's spec is the reference's (less the scan lead), on
    full-width shapes: the meta specs' shapes and dtypes are the
    reference's ``eval_shape`` too."""
    cfg = registry.get(arch)
    mesh = port_mesh(mesh_name)
    rules = lm.activation_rules(mesh)
    p = specs.params_specs(Model(cfg, device="meta"))
    got = shd.param_shardings(p, cfg, mesh, rules)
    want = ref["meshes"][mesh_name]["archs"][arch]["params"]
    seen = set()
    for path, (shape, dtype, spec) in want.items():
        for name, period in port_param_name(cfg, path):
            lead = 0 if period is None else 1
            assert list(p[name].shape) == shape[lead:], name
            assert str(p[name].dtype).replace("torch.", "") == dtype
            assert trim(as_json(got[name].spec), len(shape) - lead) == \
                trim(spec[lead:], len(shape) - lead), name
            seen.add(name)
    assert seen == set(p)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_cache_and_batch_specs_match_reference(ref, mesh_name, arch):
    """cache_shardings at decode_32k (batch 128) and long_500k (batch 1)
    for the cells that exist, and batch_shardings for every shape, with
    the meta specs' shapes and dtypes."""
    cfg = registry.get(arch)
    mesh = port_mesh(mesh_name)
    rules = lm.activation_rules(mesh)
    model = Model(cfg, device="meta")
    rec = ref["meshes"][mesh_name]["archs"][arch]
    for sname, want in rec["cache"].items():
        shape = registry.SHAPES[sname]
        c = specs.cache_specs(model, shape)
        got = port_leaves(c, shd.cache_shardings(c, cfg, mesh, rules,
                                                 shape.global_batch))
        seen = set()
        for path, (wshape, dtype, spec) in want.items():
            for port_path, period in port_cache_path(cfg, path):
                lead = 0 if period is None else 1
                gshape, leaf, gspec = got[port_path]
                if port_path != "['step']":
                    assert list(gshape) == wshape[lead:], port_path
                    assert str(leaf.dtype).replace("torch.", "") == dtype
                assert trim(as_json(gspec), len(wshape) - lead) == \
                    trim(spec[lead:], len(wshape) - lead), (sname, port_path)
                seen.add(port_path)
        assert seen == set(got)
    for sname, want in rec["batch"].items():
        shape = registry.SHAPES[sname]
        b = specs.batch_specs(cfg, shape, shape.kind == "train")
        b["decode_tokens"] = specs.decode_token_specs(shape)
        got = shd.batch_shardings(b, mesh, rules)
        assert set(got) == {keys(k)[0] for k in want}
        for path, (wshape, dtype, spec) in want.items():
            k = keys(path)[0]
            assert list(b[k].shape) == wshape
            assert str(b[k].dtype).replace("torch.", "") == dtype
            assert trim(as_json(got[k].spec), len(wshape)) == \
                trim(spec, len(wshape)), (sname, k)


def test_attach_places_shapes_without_data():
    mesh = lm.make_production_mesh(multi_pod=True)
    cfg = registry.get("yi-34b")
    p = specs.params_specs(Model(cfg, device="meta"))
    placed = shd.attach(p, shd.param_shardings(
        p, cfg, mesh, lm.activation_rules(mesh)))
    wq = placed["layers.0.mixer.wq"]
    assert wq.shape == p["layers.0.mixer.wq"].shape
    assert wq.shard_shape() == (wq.shape[0] // 16, wq.shape[1] // 16)


# ---------------------------------------------------------------------------
# The mesh module's layouts
# ---------------------------------------------------------------------------

def test_named_sharding_slabs_and_copies():
    """Each position holds the slab its coordinates select; positions
    differing only along unnamed axes hold copies; gather places them
    back exactly; ``shard_shape`` is each slab's shape."""
    mesh = M.Mesh(np.array([[[CPU] * 2] * 2] * 2, dtype=object),
                  ("pod", "data", "model"))
    x = torch.randn(8, 8, dtype=torch.bfloat16)
    for spec in (P(("pod", "data"), "model"), P("data", None), P(),
                 P(None, ("model", "pod")), P("model")):
        sh = M.NamedSharding(mesh, spec)
        st = M.distribute(x, sh)
        for coords, slab in st.items():
            assert slab.shape == M.shard_shape(x.shape, sh)
            assert torch.equal(slab, x[sh.slices(coords, x.shape)])
        assert torch.equal(st.gather(), x)
        assert st.nbytes() == 8 * slab.numel() * 2
    st = M.distribute(x, M.NamedSharding(mesh, P(("pod", "data"))))
    assert torch.equal(st.gather(where={"pod": 1, "data": 0}), x[4:6])
    st.write_block(torch.zeros(2, 8, dtype=x.dtype), {"pod": 1, "data": 0})
    assert float(st.gather()[4:6].abs().sum()) == 0.0
    assert torch.equal(st.slabs[1, 0, 0], st.slabs[1, 0, 1])
    with pytest.raises(ValueError, match="divide"):
        M.NamedSharding(mesh, P("data")).shard_shape((3,))
    with pytest.raises(ValueError, match="not on the mesh"):
        M.NamedSharding(mesh, P("x"))
    with pytest.raises(ValueError, match="NamedSharding"):
        mesh.device_list("data")


def test_host_mesh_takes_the_card_unless_named(monkeypatch):
    m = lm.make_host_mesh(2, [CPU] * 8)
    assert m.shape == {"data": 4, "model": 2}
    assert lm.batch_axes(m) == ("data",)
    assert lm.batch_axes(lm.make_production_mesh(multi_pod=True)) == \
        ("pod", "data")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.make_host_mesh()
    with pytest.raises(ValueError, match="one device type"):
        lm.make_host_mesh(1, [CPU, torch.device("meta")])


def test_use_mesh_rules_answers_the_mesh_sizes():
    """On a multi-device mesh ``axis_size`` answers the mesh's sizes, so
    the model takes the reference's branches; shard and
    gather_for_compute stay the identity on a position's whole tensors."""
    from repro_torch.models.attention import _kv_spec
    mesh = lm.make_host_mesh(2, [CPU] * 8)
    x = torch.randn(4, 3)
    with sharding.use_mesh_rules(mesh, lm.activation_rules(mesh)):
        assert sharding.axis_size("batch") == 4
        assert sharding.axis_size("heads") == 2
        assert _kv_spec(4, 16) == (None, "heads", None)
        assert _kv_spec(1, 16) == (None, None, "heads")
        assert sharding.shard(x, "batch", None) is x
        assert sharding.gather_for_compute(x, None, "ff") is x
    assert sharding.axis_size("heads") == 1
