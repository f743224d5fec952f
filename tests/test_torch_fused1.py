"""repro_torch RDA ``fused1`` (the megakernel) vs the JAX reference on the
CPU: ``ops.mega_spectral_op`` against ``repro.kernels.ops.mega_spectral_op``
in Pallas interpret mode in both residencies, the compiler's mega step,
the residency cut, and the ``fused1`` pipeline on the 128^2 point-target
scene. The hand-written CUDA megakernels are held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as numpy arrays. Tolerances are the reference's own (tests/test_kernels.py):
2e-4 x max|want| at f32, 5e-2 at bs16.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import plan as jplan
from repro.core.sar import build_pipeline as jbuild
from repro.core.sar import metrics as jmetrics
from repro.core.sar import paper_targets as jtargets
from repro.core.sar import rda as jrda
from repro.core.sar import simulate_cached as jsimulate_cached
from repro.core.sar.geometry import test_scene as make_jscene
from repro.kernels import ops as jops

import repro_torch.core.sar as P
from repro_torch.core import plan as tplan
from repro_torch.kernels import _build
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops

F32_TOL = 2e-4
BS16_TOL = 5e-2
NA, NR = 32, 64          # non-square: the two axes factor differently
MODES = ["none", "shared", "full", "outer", "shared_outer"]

# Segment chains: fused1's shape (col fwd -> row fwd*filter*inv -> col
# filter*inv) with each filter mode on both axes, a same-axis boundary
# after a forward-only row segment, and a filter-only segment.
CHAINS = {f"fused1_{m}": ((0, True, False, "none"), (1, True, True, m),
                          (0, False, True, m)) for m in MODES}
CHAINS["same_axis"] = ((1, True, False, "shared"), (1, False, True, "full"),
                       (0, True, True, "outer"))
CHAINS["filter_only"] = ((1, False, False, "full"),
                         (0, True, True, "shared_outer"))


def payload(rng, mode, axis, rank=2):
    """One segment's filter payload in scene coordinates (numpy)."""
    n, lines = (NR, NA) if axis == 1 else (NA, NR)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = []
    if mode in ("shared", "shared_outer"):
        out += [rand(n), rand(n)]
    if mode == "full":
        out += [rand(NA, NR), rand(NA, NR)]
    if mode in ("outer", "shared_outer"):
        out += [0.1 * rand(lines, rank), rand(n, rank)]
    return out


def make_case(seed, segments, batch=2):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((batch, NA, NR)).astype(np.float32)
         for _ in range(2)]
    args = [a for s in segments for a in payload(rng, s[3], s[0])]
    return x, args


def port(x, args, **kw):
    out = tops.mega_spectral_op(*(torch.from_numpy(a) for a in x),
                                *(torch.from_numpy(a) for a in args), **kw)
    return tuple(o.numpy() for o in out)


def ref(x, args, **kw):
    out = jops.mega_spectral_op(*(jnp.asarray(a) for a in x),
                                *(jnp.asarray(a) for a in args), **kw)
    return tuple(np.asarray(o) for o in out)


def assert_close(got, want, tol=F32_TOL):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0)


# ---------------------------------------------------------------------------
# The op against the reference's interpret-mode megakernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residency", ["vmem", "staged"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_mega_op_matches_reference(chain, residency):
    segments = CHAINS[chain]
    x, args = make_case(len(chain), segments)
    kw = dict(segments=segments, residency=residency)
    assert_close(port(x, args, **kw), ref(x, args, **kw))


@pytest.mark.parametrize("residency", ["vmem", "staged"])
def test_mega_op_bs16_matches_reference(residency):
    segments = CHAINS["fused1_shared_outer"]
    x, args = make_case(7, segments)
    kw = dict(segments=segments, residency=residency, precision="bs16")
    assert_close(port(x, args, **kw), ref(x, args, **kw), BS16_TOL)


def test_mega_op_unbatched_and_eight_field_records():
    segments = CHAINS["fused1_outer"]
    x, args = make_case(3, segments, batch=1)
    x1 = [a[0] for a in x]
    ext = tuple(s + (None, None, None, True) for s in segments)
    got = port(x1, args, segments=ext)
    assert got[0].shape == (NA, NR)
    assert_close(got, ref(x1, args, segments=ext))
    assert_close(got, port(x1, args, segments=segments))


def test_exponent_carry_chains_like_one_call():
    """bs16: two calls chained by return_exp / exp_in equal one call."""
    segments = CHAINS["fused1_shared_outer"]
    x, args = make_case(11, segments)
    t = [torch.from_numpy(a) for a in x + args]
    xr, xi, (h1r, h1i, u1, v1, h2r, h2i, u2, v2) = t[0], t[1], t[2:]
    kw = dict(precision="bs16")
    one = tops.mega_spectral_op(xr, xi, h1r, h1i, u1, v1, h2r, h2i, u2, v2,
                                segments=segments, **kw)
    ar, ai, exp = tops.mega_spectral_op(xr, xi, h1r, h1i, u1, v1,
                                        segments=segments[:2],
                                        return_exp=True, **kw)
    assert exp.shape == (2, NA, 1)          # rows: one exponent per line
    two = tops.mega_spectral_op(ar, ai, h2r, h2i, u2, v2,
                                segments=segments[2:], exp_in=exp, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    with pytest.raises(ValueError, match="block-scaled"):
        tops.mega_spectral_op(xr, xi, segments=((0, True, False, "none"),),
                              return_exp=True)


def test_mega_op_validates_like_reference():
    segments = CHAINS["fused1_none"]
    x, args = make_case(5, segments)
    for kw, match in ((dict(residency="staged", phase_block=24),
                       "phase_block"),
                      (dict(residency="vmem", batch_block=3), "batch_block"),
                      (dict(residency="hbm"), "residency"),
                      (dict(buffer_depth=0), "buffer_depth")):
        with pytest.raises(ValueError, match=match):
            port(x, args, segments=segments, **kw)
        with pytest.raises(ValueError, match=match):
            ref(x, args, segments=segments, **kw)
    with pytest.raises(ValueError, match="consume"):
        port(x, args + [x[0][0, 0]], segments=segments)


def test_staged_phases_and_flops_match_reference():
    from repro.kernels import fft4step as jfft
    segs = tuple(tfft.SegmentSpec(*s) for s in CHAINS["same_axis"])
    mine = tfft.MegaSpec(NA, NR, segs, residency="staged", phase_block=16)
    theirs = jfft.MegaSpec(NA, NR, tuple(jfft.SegmentSpec(*s)
                                         for s in CHAINS["same_axis"]),
                           residency="staged", phase_block=16)
    strip = ("seg",)
    p1, n1 = tfft._staged_phases(mine)
    p2, n2 = jfft._staged_phases(theirs)
    assert n1 == n2 and [{k: v for k, v in p.items() if k not in strip}
                         for p in p1] == \
        [{k: v for k, v in p.items() if k not in strip} for p in p2]
    assert tfft._mega_flops(mine) == jfft._mega_flops(theirs)
    assert mine.turns == theirs.turns == 1
    assert [k for k, _ in tfft._mega_const_plan(mine)] == \
        [k for k, _ in jfft._mega_const_plan(theirs)]
    assert [tfft._seg_filter_shapes(mine, s) for s in segs] == \
        [jfft._seg_filter_shapes(theirs, s) for s in theirs.segments]


# ---------------------------------------------------------------------------
# The residency cut and the compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na,nr,batch_block,want", [
    (128, 128, 1, "vmem"), (64, 128, 1, "vmem"), (128, 64, 1, "vmem"),
    (128, 128, 2, "staged"), (256, 256, 1, "staged"),
    (4096, 4096, 1, "staged")])
def test_mega_residency_cut(na, nr, batch_block, want):
    assert tops.mega_residency(na, nr, batch_block) == want


_cache = {}


def jscene():
    if "raw" not in _cache:
        cfg = make_jscene(128)
        _cache["cfg"] = cfg
        _cache["targets"] = jtargets(cfg)
        _cache["raw"] = np.array(jsimulate_cached(cfg, _cache["targets"]),
                                 np.complex64)
    return _cache["cfg"], _cache["targets"], _cache["raw"]


def tcfg(n=128):
    cfg = dataclasses.asdict(make_jscene(n))
    return P.scene_from_dict(cfg)


def test_fused1_compiles_to_one_mega_launch():
    pipe = P.build_pipeline(tcfg(), "fused1", device="cpu")
    assert pipe.dispatches == P.documented_dispatches("fused1") == 1
    assert jrda.documented_dispatches("fused1") == 1
    assert pipe.hbm_roundtrips == 1
    (step,) = pipe.steps
    assert step.kind == "mega" and step.filter_mode == tplan.MEGA
    kk = step.kernel_kw
    assert kk["segments"] == ((0, True, False, "none"),
                              (1, True, True, "shared_outer"),
                              (0, False, True, "outer"))
    assert kk["residency"] == "vmem"
    assert [len(a) for a in step.seg_filter_args] == [0, 4, 2]
    assert P.build_pipeline(tcfg(256), "fused1", device="cpu").steps[
        0].kernel_kw["residency"] == "staged"
    pinned = P.build_pipeline(tcfg(), "fused1", device="cpu",
                              residency="staged", phase_block=16,
                              buffer_depth=1)
    assert {k: pinned.steps[0].kernel_kw[k] for k in
            ("residency", "phase_block", "buffer_depth")} == \
        dict(residency="staged", phase_block=16, buffer_depth=1)


@pytest.mark.parametrize("plan_name", ["plan_fused1", "plan_fused3"])
@pytest.mark.parametrize("fuse", [True, tplan.FUSE_MEGA])
def test_fused_dispatch_counts_match_reference(plan_name, fuse):
    from repro_torch.core.sar import rda as trda
    jfuse = jplan.FUSE_MEGA if fuse == tplan.FUSE_MEGA else fuse
    mine = tplan.plan_dispatch_count(getattr(trda, plan_name)(), fuse)
    assert mine == jplan.plan_dispatch_count(getattr(jrda, plan_name)(),
                                             jfuse)
    assert mine == (1 if fuse == tplan.FUSE_MEGA else 3)


# ---------------------------------------------------------------------------
# The slice: fused1 on the 128^2 scene
# ---------------------------------------------------------------------------

def port_fused1(raw, **kw):
    return P.build_pipeline(tcfg(), "fused1", device="cpu", **kw).run(
        torch.from_numpy(raw)).numpy()


def test_fused1_matches_live_reference():
    cfg, targets, raw = jscene()
    want = np.asarray(jbuild(cfg, "fused1", tune="off").run(
        jnp.asarray(raw)))
    got = port_fused1(raw)
    assert got.dtype == np.complex64 and np.isfinite(got).all()
    cmp = jmetrics.compare_pipelines(got, want, cfg, targets)
    assert cmp["l2_relative_error"] <= 1e-5, cmp["l2_relative_error"]
    assert max(cmp["snr_delta_db"]) <= 0.01, cmp["snr_delta_db"]
    assert [(r.row, r.col) for r in cmp["reports_a"]] == \
        [(r.row, r.col) for r in cmp["reports_b"]]


def test_fused1_close_to_fused3_and_torch_backend():
    _, _, raw = jscene()
    got = port_fused1(raw)
    f3 = P.build_pipeline(tcfg(), "fused3", device="cpu").run(
        torch.from_numpy(raw)).numpy()
    scale = np.abs(f3).max()
    assert np.abs(got - f3).max() <= F32_TOL * scale
    oracle = port_fused1(raw, backend="torch")
    assert np.abs(got - oracle).max() <= F32_TOL * scale


def test_fused1_batch_equals_per_scene_runs():
    _, _, raw = jscene()
    pipe = P.build_pipeline(tcfg(), "fused1", device="cpu")
    second = raw[::-1].copy() * np.complex64(0.5)
    batch = torch.from_numpy(np.stack([raw, second]))
    out = pipe.run(batch)
    assert out.shape == batch.shape
    assert torch.equal(out[0], pipe.run(torch.from_numpy(raw)))
    assert torch.equal(out[1], pipe.run(torch.from_numpy(second)))


# ---------------------------------------------------------------------------
# The kernel build
# ---------------------------------------------------------------------------

def test_build_rebuilds_when_a_shared_header_is_newer(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    src, hdr = csrc / "k.cu", csrc / "common.cuh"
    src.write_text("")
    hdr.write_text("")
    assert _build.sources() == {"k": str(src)}
    assert _build._stale("k", str(src))            # nothing built yet
    lib = build / "libk.so"
    lib.write_text("")
    os.utime(src, (100, 100))
    os.utime(hdr, (100, 100))
    os.utime(lib, (200, 200))
    assert not _build._stale("k", str(src))
    os.utime(hdr, (300, 300))
    assert _build._stale("k", str(src))            # header edited
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert _build._stale("k", str(src))            # source edited
