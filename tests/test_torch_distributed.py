"""The port's multi-device path on the CPU: ``repro_torch.distributed.mesh``
(a single-process mesh over a device list, its three collectives) and
``repro_torch.core.sar.distributed`` (corner2, halo, ``lower_pipeline``
with megakernel phase groups), on ``make_sar_mesh(devices=[cpu] * 8)`` —
eight slabs in one process, as the reference's tests emulate eight XLA
CPU devices.

Inside the port the sharded images are held ``torch.equal`` to the local
route where the reference claims bit identity (corner2 and lowered fused3
== local fused3; lowered fused1 / csa_fused1 == their per-axis twins and
the local megakernel; bs16 sharded == local bs16; batched == per scene),
and by the reference's gates elsewhere: halo against ``unfused`` at
l2 < 1e-5 and |dSNR| < 0.01 dB, omegak_fused1 and bf16 turns within 0.1
dB, and bit for bit its one-device twin (``plan_halo``). Against the
live JAX package, on the same numpy raw scene: the
reference's local fused3 / fused1 (in-process) and its 8-device corner2
and halo (one subprocess with ``XLA_FLAGS`` emulating 8 devices), within
2e-4 x max|want| (the reference's kernel tolerance) and 0.1 dB — never
exact equality: the reference's own f32 bits drift across JAX versions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - see requirements-dev.txt
    from _hypothesis_fallback import given, settings, strategies as st

import jax.numpy as jnp
from repro.core.sar import build_pipeline as jbuild
from repro.core.sar.geometry import test_scene as make_jscene

from repro_torch.core.sar import (build_pipeline, metrics, paper_targets,
                                  simulate)
from repro_torch.core.sar import distributed as D
from repro_torch.core.sar.geometry import test_scene as make_scene
from repro_torch.distributed import mesh as M
from repro_torch.kernels import ops

N = 256
P = 8
CPU = torch.device("cpu")
TOL = 2e-4            # x max|want|, the reference's kernel tolerance
GATE_DB = 0.1         # the precision / omega-K gate
HALO_L2 = 1e-5        # halo vs unfused: the reference's bounds
HALO_DB = 0.01
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_cache = {}


def cfg():
    return make_scene(N)


def targets():
    return paper_targets(cfg())


def raw():
    if "raw" not in _cache:
        _cache["raw"] = simulate(cfg(), targets(), device="cpu")
    return _cache["raw"]


def mesh(p=P):
    return D.make_sar_mesh(devices=[CPU] * p)


def local(variant, **kw):
    key = (variant, tuple(sorted(kw.items())))
    if key not in _cache:
        _cache[key] = build_pipeline(cfg(), variant, device="cpu",
                                     tune="off", **kw).run(raw())
    return _cache[key]


def pipe(variant, **kw):
    return build_pipeline(cfg(), variant, device="cpu", tune="off", **kw)


def within_gate(img, want, gate=GATE_DB):
    c = metrics.compare_pipelines(np.asarray(img), np.asarray(want), cfg(),
                                  targets())
    assert ([(r.row, r.col) for r in c["reports_a"]]
            == [(r.row, r.col) for r in c["reports_b"]])
    assert max(c["snr_delta_db"]) <= gate, c["snr_delta_db"]
    return c


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(b=st.integers(1, 3), na_blocks=st.integers(1, 5),
       nr_blocks=st.integers(1, 5), p=st.sampled_from([1, 2, 4, 8]),
       stream=st.sampled_from([0, 1]), batched=st.sampled_from([False, True]))
def test_corner_turn_is_permutation_identity(b, na_blocks, nr_blocks, p,
                                             stream, batched):
    """shard(stream) -> all_to_all -> unshard(other) is the identity for
    any (B, na, nr) and device count dividing both axes, and turning back
    restores the original slabs."""
    na, nr = p * na_blocks, p * nr_blocks
    shape = (b, na, nr) if batched else (na, nr)
    bpre = len(shape) - 2
    x = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    devs = [CPU] * p
    slabs = M.shard(x, bpre + stream, devs)
    turned = D._turn(slabs, stream, bpre)
    assert torch.equal(M.unshard(turned, bpre + 1 - stream), x)
    back = D._turn(turned, 1 - stream, bpre)
    for s, t in zip(back, slabs):
        assert torch.equal(s, t)


@settings(max_examples=30, deadline=None)
@given(na_blocks=st.integers(1, 5), nr_blocks=st.integers(1, 5),
       p=st.sampled_from([1, 2, 4, 8]), stream=st.sampled_from([0, 1]))
def test_carried_exponent_turn_is_pair_permutation(na_blocks, nr_blocks, p,
                                                   stream):
    """The bs16 turn: the scaled slab rides all_to_all, its per-line
    exponents all_gather along the OLD stream axis; applying them before
    the turn (per-slab slices) and after it (the gathered vector) gives
    the same image — no pair is split, scaled twice or dropped."""
    na, nr = p * na_blocks, p * nr_blocks
    x = torch.arange(na * nr, dtype=torch.float64).reshape(na, nr) + 1.0
    n_lines = na if stream == 0 else nr
    e = torch.arange(n_lines, dtype=torch.float64) % 7 - 3
    ecol = e.reshape(-1, 1) if stream == 0 else e.reshape(1, -1)
    want = x * 2.0 ** ecol
    devs = [CPU] * p
    slabs = M.shard(x, stream, devs)
    eslabs = M.shard(ecol, stream, devs)
    pre = [s * 2.0 ** es for s, es in zip(slabs, eslabs)]
    assert torch.equal(M.unshard(pre, stream), want)
    turned = M.all_to_all(slabs, 1 - stream, stream)
    gathered = M.all_gather(eslabs, stream)
    assert all(torch.equal(g, ecol) for g in gathered)
    post = [t * 2.0 ** g for t, g in zip(turned, gathered)]
    assert torch.equal(M.unshard(post, 1 - stream), want)


def test_ppermute_and_all_gather_follow_the_jax_semantics():
    slabs = [torch.full((2, 3), float(i)) for i in range(4)]
    ring = M.ppermute(slabs, [((i + 1) % 4, i) for i in range(4)])
    assert [float(s[0, 0]) for s in ring] == [1.0, 2.0, 3.0, 0.0]
    partial = M.ppermute(slabs, [(0, 1)])       # unnamed destinations: 0
    assert [float(s.abs().sum()) for s in partial] == [0.0, 0.0, 0.0, 0.0]
    partial = M.ppermute(slabs, [(3, 1)])
    assert float(partial[1][0, 0]) == 3.0 and float(partial[0].sum()) == 0
    with pytest.raises(ValueError, match="destination of two"):
        M.ppermute(slabs, [(0, 1), (2, 1)])
    g = M.all_gather(slabs, 1)
    assert all(t.shape == (2, 12) for t in g)
    assert torch.equal(g[2], torch.cat(slabs, dim=1))


def test_make_sar_mesh_axes_and_devices(monkeypatch):
    m = mesh()
    assert m.axis_names == ("data",) and m.size("data") == P
    assert m.devices.shape == (P,) and m.shape == {"data": P}
    m2 = D.make_sar_mesh(axes=("pod", "data"), devices=[CPU] * P)
    assert m2.devices.shape == (1, P) and m2.size(("pod", "data")) == P
    assert m2.device_list(("pod", "data")) == [CPU] * P
    with pytest.raises(ValueError, match="axis names"):
        D.make_sar_mesh(axes=("a", "b", "c"), devices=[CPU])
    with pytest.raises(ValueError, match="one device type"):
        M.Mesh([torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="not sharded over"):
        M.Mesh(np.array([[CPU, CPU], [CPU, CPU]], dtype=object),
               ("pod", "data")).device_list("data")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.make_sar_mesh()


# ---------------------------------------------------------------------------
# corner2, halo and the generic lowering against the local routes
# ---------------------------------------------------------------------------

def test_corner2_equals_lowered_and_local_fused3():
    c2 = D.build_corner2(cfg(), mesh())
    img = c2(raw())
    assert (c2.devices, c2.dispatches_per_device, c2.turns) == (P, 3, 2)
    assert torch.equal(img, local("fused3"))
    lowered = pipe("fused3").lower_sharded(mesh())
    assert torch.equal(lowered(raw()), img)
    # the multi-axis mesh shape: processes x local devices
    m2 = D.make_sar_mesh(axes=("pod", "data"), devices=[CPU] * P)
    assert torch.equal(D.build_corner2(cfg(), m2, axes=("pod", "data"))(
        raw()), img)


def test_corner2_bf16_turns_within_the_gate():
    img = D.build_corner2(cfg(), mesh(), turn_dtype=torch.bfloat16)(raw())
    assert not torch.equal(img, local("fused3"))
    within_gate(img, local("fused3"))


def test_halo_against_unfused():
    run = D.build_halo(cfg(), mesh())
    assert (run.devices, run.dispatches_per_device, run.turns) == (P, 3, 1)
    c = metrics.compare_pipelines(run(raw()).numpy(),
                                  local("unfused").numpy(), cfg(), targets())
    assert c["l2_relative_error"] < HALO_L2, c["l2_relative_error"]
    assert max(c["snr_delta_db"]) < HALO_DB, c["snr_delta_db"]


def test_halo_equals_its_one_device_twin():
    """The halo schedule at any P is its one-device plan (``plan_halo``:
    the same three spectral launches and sinc RCMC) bit for bit: the
    ring exchange moves values, it computes nothing."""
    from repro_torch.core import plan as planlib
    twin = planlib.compile_plan(D.plan_halo(), cfg(), device="cpu",
                                tune="off")
    assert [s.kind for s in twin.steps] == ["spectral", "spectral",
                                            "sinc_rcmc", "spectral"]
    want = twin.run(raw())
    for p in (1, 2, P):
        assert torch.equal(D.build_halo(cfg(), mesh(p))(raw()), want)


@pytest.mark.parametrize("variant,twin", [("fused1", "fused3"),
                                          ("csa_fused1", "csa_fused"),
                                          ("omegak_fused1", "omegak")])
def test_lowered_megakernel_equals_its_twins(variant, twin, monkeypatch):
    """Three phase groups (azimuth FFT; range fwd . H . inv; azimuth H .
    inv), one megakernel call per device per group, two turns: equal to
    the per-axis twin (omega-K: within 0.1 dB, as the reference holds it)
    and to the local megakernel."""
    calls = []
    real = ops.mega_spectral_op

    def counted(*a, **k):
        calls.append(k["segments"])
        return real(*a, **k)
    monkeypatch.setattr(ops, "mega_spectral_op", counted)
    run = pipe(variant).lower_sharded(mesh())
    assert (run.devices, run.dispatches_per_device, run.turns) == (P, 3, 2)
    assert [u["stream_axis"] for u in run.unit_info] == [1, 0, 1]
    assert [u["residency"] for u in run.unit_info] == ["vmem"] * 3
    img = run(raw())
    assert len(calls) == run.dispatches_per_device * P
    monkeypatch.setattr(ops, "mega_spectral_op", real)
    if variant == "omegak_fused1":
        within_gate(img, local(twin))
    else:
        assert torch.equal(img, local(twin))
    assert torch.equal(img, local(variant))


def test_pinned_staged_residency_gives_the_same_bits():
    run = pipe("fused1").lower_sharded(mesh(), residency="staged")
    assert [u["residency"] for u in run.unit_info] == ["staged"] * 3
    assert torch.equal(run(raw()), local("fused3"))


def test_batched_lowering_gives_the_same_bits_per_scene():
    rawb = torch.stack([raw(), 2 * raw()])
    want = build_pipeline(cfg(), "fused3", device="cpu", tune="off").run(rawb)
    for variant in ("fused1", "fused3"):
        got = pipe(variant).lower_sharded(mesh())(rawb)
        assert got.shape == rawb.shape and torch.equal(got, want)
    assert torch.equal(D.build_corner2(cfg(), mesh())(rawb), want)


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_bs16_sharded_equals_local_bs16(fft_impl):
    p1 = pipe("fused1", precision="bs16", fft_impl=fft_impl)
    run = p1.lower_sharded(mesh())
    assert [u["carries_exponents"] for u in run.unit_info] == [True] * 3
    img = run(raw())
    assert torch.equal(img, p1.run(raw()))
    assert torch.equal(img, pipe("fused3", precision="bs16",
                                 fft_impl=fft_impl).run(raw()))
    assert not torch.equal(img, local("fused3"))


def test_lowering_shape_follows_the_mesh_size():
    for p in (1, 2, 4):
        run = pipe("fused1").lower_sharded(mesh(p))
        assert (run.devices, run.dispatches_per_device, run.turns) == \
            (p, 3, 2)
        assert torch.equal(run(raw()), local("fused3"))


def test_refusals():
    with pytest.raises(ValueError, match="fused1"):
        pipe("fused").lower_sharded(mesh())
    with pytest.raises(ValueError, match="not divisible"):
        pipe("fused3").lower_sharded(mesh(3))
    with pytest.raises(ValueError, match="halo exceeds local slab width"):
        D.build_halo(cfg(), mesh(32))
    with pytest.raises(ValueError, match="unknown schedule"):
        D.build_sharded(cfg(), "fused3", mesh(), schedule="ring")
    with pytest.raises(ValueError, match="not an RDA"):
        D.build_sharded(cfg(), "csa_fused", mesh(), schedule="halo")
    with pytest.raises(ValueError, match="precision"):
        D.build_sharded(cfg(), "fused3", mesh(), schedule="halo",
                        precision="bf16")


def test_build_sharded_and_distributed_focus_route_to_the_schedules():
    want = local("fused3")
    run = D.build_sharded(cfg(), "fused3", mesh(), tune="off")
    assert torch.equal(run(raw()), want)
    assert torch.equal(D.distributed_focus(raw(), cfg(), mesh()), want)
    assert set(D.SCHEDULES) == {"corner2", "halo"}


# ---------------------------------------------------------------------------
# Against the live JAX package, on the same numpy raw scene
# ---------------------------------------------------------------------------

def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= TOL * scale
    within_gate(got, want)


@pytest.mark.parametrize("variant", ["fused3", "fused1"])
def test_lowered_matches_the_references_local_route(variant):
    raw_np = raw().numpy()
    want = np.asarray(jbuild(make_jscene(N), variant).run(
        jnp.asarray(raw_np)))
    got = pipe(variant).lower_sharded(mesh())(torch.from_numpy(raw_np))
    assert_close(got.numpy(), want)


_JAX_SCRIPT = """
import sys, numpy as np, jax
from repro.core.sar import test_scene
from repro.core.sar.distributed import build_corner2, build_halo
raw = np.load(sys.argv[1])
cfg = test_scene(raw.shape[0])
mesh = jax.make_mesh((8,), ("data",))
np.savez(sys.argv[2], corner2=np.asarray(build_corner2(cfg, mesh)(raw)),
         halo=np.asarray(build_halo(cfg, mesh)(raw)))
"""


def test_corner2_and_halo_match_the_references_8_device_schedules(tmp_path):
    """The reference's own 8-device corner2 and halo (XLA's host platform
    split into 8 devices, in a subprocess) on the port's raw scene."""
    raw_np = raw().numpy()
    np.save(tmp_path / "raw.npy", raw_np)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp_path / "raw.npy"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = np.load(tmp_path / "out.npz")
    assert_close(D.build_corner2(cfg(), mesh())(raw()).numpy(),
                 want["corner2"])
    assert_close(D.build_halo(cfg(), mesh())(raw()).numpy(), want["halo"])
