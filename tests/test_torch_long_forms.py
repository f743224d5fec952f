"""Every precision past one block of the CUDA kernels (N > 4096, or a
three-factor split): bf16, f16, bs16 and Karatsuba on the port's plain
versions against the JAX reference, where the f16 range overflows in both
packages (open check B), the compiler's residency cut for scenes with
such lines, and the tuner's space past 4096.

Inputs come from ``np.random.default_rng(seed)`` (or the reference's
simulator) and go to both packages as numpy arrays; the reference's
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Tolerance where the operands narrow: the 5e-5 x max|want| bar of
tests/test_torch_kernels.py::test_narrow_precisions_round_where_the_
reference_does (both packages round every operand where the other does)
on at least half the points — most agree bit for bit — and the card's bar
for the form (``FORM_TOL``, chip_smoke.py) on every point. Past one block
a sum runs over up to 128 terms and a line over 8192 points or more, so
the order of the f32 sums (torch's einsum against XLA's dot) puts some
intermediates on the other side of a 16-bit rounding, and each such flip
moves the points it feeds by about one 16-bit ulp: the largest error
passes 5e-5 (up to 7e-4 x max|want| at bf16, N = 32768), the median does
not. A rounding the reference does not make (the f32 form's two stages
for a 128-point factor) puts the median past it
(``test_a_two_stage_factor_misses_the_rounding_bar``). At f32: 2e-4 x
max|want| on every point. The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py
(phase 20).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.sar import build_pipeline as jbuild
from repro.core.sar import metrics as jmetrics
from repro.core.sar import paper_targets as jtargets
from repro.core.sar import simulate_cached as jsimulate_cached
from repro.core.sar.geometry import test_scene as make_jscene
from repro.kernels import fft4step as jfft
from repro.kernels import ops as jops

import repro_torch.core.sar as P
from repro_torch.core.sar.geometry import test_scene as tscene
from repro_torch import tuning as tt
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops
from repro_torch.tuning import cost

F32_TOL = 2e-4
ROUNDING_TOL = 5e-5
FORM_TOL = {"bf16": 1e-2, "f16": 2e-3, "bs16": 2e-3}
# (precision, karatsuba) of the forms past one block besides plain f32
FORMS = [("bf16", False), ("f16", False), ("bs16", False), ("bs16", True),
         ("f32", True)]


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got, want, tol):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0)


def spectral_case(seed, n, axis, lines=3, batch=2):
    rng = np.random.default_rng(seed)
    scene = (lines, n) if axis == 1 else (n, lines)
    x = (rand(rng, batch, *scene), rand(rng, batch, *scene))
    return x, dict(hr=rand(rng, *scene), hi=rand(rng, *scene))


def both(x, filt, **kw):
    want = jops.spectral_op(*(jnp.asarray(a) for a in x),
                            **{k: jnp.asarray(v) for k, v in filt.items()},
                            **kw)
    got = tops.spectral_op(*(torch.from_numpy(a) for a in x),
                           **{k: torch.from_numpy(v)
                              for k, v in filt.items()}, **kw)
    return got, want


def past_bar(got, want):
    """(median and largest |got - want|, each over max|want|)."""
    g = np.stack([np.asarray(a) for a in got])
    w = np.stack([np.asarray(a) for a in want])
    scale = float(np.abs(w).max())
    d = np.abs(g - w)
    return float(np.median(d)) / scale, float(d.max()) / scale


def assert_rounds_where(got, want, precision):
    """The form's bar (see the module docstring)."""
    if precision == "f32":
        assert_close(got, want, F32_TOL)
        return
    median, worst = past_bar(got, want)
    assert median <= ROUNDING_TOL and worst <= FORM_TOL[precision], (
        median, worst)


# ---------------------------------------------------------------------------
# Open check B: where the f16 range overflows, in both packages
# ---------------------------------------------------------------------------

_scenes = {}


def scene(name):
    """The reference's test scene (n^2, or 64 lines of nr samples) and its
    simulated echoes, shared by both packages."""
    if name not in _scenes:
        if name.startswith("64x"):
            cfg = dataclasses.replace(make_jscene(64), nr=int(name[3:]))
        else:
            cfg = make_jscene(int(name))
        raw = np.array(jsimulate_cached(cfg, jtargets(cfg)), np.complex64)
        _scenes[name] = (cfg, raw)
    return _scenes[name]


def images(name, precision, variant="fused3"):
    cfg, raw = scene(name)
    want = np.asarray(jbuild(cfg, variant, tune="off",
                             precision=precision).run(jnp.asarray(raw)))
    tcfg = P.scene_from_dict(dataclasses.asdict(cfg))
    got = P.build_pipeline(tcfg, variant, device="cpu", tune="off",
                           precision=precision).run(
        torch.from_numpy(raw)).numpy()
    return got, want


@pytest.mark.parametrize("name,overflows", [("64", False), ("128", True),
                                            ("256", True),
                                            ("64x8192", True)])
def test_f16_overflows_where_the_reference_does(name, overflows):
    """The matmul route's f16 fused3 image: finite at 64-point lines, and
    from the 128-point lines of test_scene(128) on (the shortest) it has
    non-finite pixels — the same pixels in the live reference, so the
    port's f16 rounds where the reference's does and overflows with it."""
    got, want = images(name, "f16")
    bad, ref_bad = ~np.isfinite(got), ~np.isfinite(want)
    assert bool(bad.any()) == overflows
    np.testing.assert_array_equal(bad, ref_bad)


@pytest.mark.parametrize("name", ["128", "256", "64x8192", "64x16384"])
def test_bs16_stays_finite_where_the_reference_does(name):
    """bs16's per-line exponents keep the image finite at every line the
    CPU runs in seconds (up to 16384 points), in both packages. The
    reference takes its exponents with a float32 log2, one off just above a
    power of two, where the port reads them from the bits; masks are
    compared on the lines (the first launch's, the raw scene's columns)
    whose exponents agree, which here is every line."""
    cfg, raw = scene(name)
    got, want = images(name, "bs16")
    xr, xi = raw.real.copy(), raw.imag.copy()
    e_port = tfft.line_exponents(torch.from_numpy(xr), torch.from_numpy(xi),
                                 0).numpy()[0]
    e_ref = np.asarray(jfft.line_exponents(jnp.asarray(xr), jnp.asarray(xi),
                                           0))[0]
    agree = e_port == e_ref
    assert agree.all()
    bad, ref_bad = ~np.isfinite(got), ~np.isfinite(want)
    np.testing.assert_array_equal(bad[:, agree], ref_bad[:, agree])
    assert not bad.any()


# ---------------------------------------------------------------------------
# The plain versions' forms past one block against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,karatsuba", FORMS)
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("n,split", [(8192, None), (32768, None),
                                     (512, (8, 8, 8)),
                                     (8192, (32, 16, 16))])
def test_plain_long_forms_match_reference(n, split, axis, precision,
                                          karatsuba):
    """fwd * H * inv past one block at each form: the plain version rounds
    every operand where the reference's kernel does (one f32 sum a
    factor), within the narrow precisions' bar."""
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    x, filt = spectral_case(n + axis + 3 * karatsuba, n, axis)
    got, want = both(x, filt, axis=axis, fwd=True, inv=True,
                     filter_mode="full", precision=precision,
                     karatsuba=karatsuba, **kw)
    assert_rounds_where(got, want, precision)


@pytest.mark.parametrize("fwd,inv", [(True, False), (False, True)])
@pytest.mark.parametrize("precision", ["bf16", "bs16"])
def test_plain_long_forms_one_direction_match_reference(precision, fwd,
                                                        inv):
    x, filt = spectral_case(9, 8192, 0, lines=5)
    got, want = both(x, filt, axis=0, fwd=fwd, inv=inv, filter_mode="full",
                     precision=precision)
    assert_rounds_where(got, want, precision)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_a_two_stage_factor_misses_the_rounding_bar(precision):
    """The bar above tells rounding structures apart: the plain version
    with the 128-point factor of 8192 = 128 x 64 in two stages (16 x 8),
    as the f32 form's device-memory passes run it, rounds an intermediate
    the reference never rounds and puts the median point past it."""
    x, filt = spectral_case(8192, 8192, 0)
    kw = dict(axis=0, fwd=True, inv=True, filter_mode="full",
              precision=precision)
    _, want = both(x, filt, **kw)
    two = tops.spectral_op(*(torch.from_numpy(a) for a in x),
                           **{k: torch.from_numpy(v)
                              for k, v in filt.items()},
                           n1=16, n2=8, n3=64, **kw)
    median, _ = past_bar(two, want)
    assert median > ROUNDING_TOL


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_mega_plain_bs16_long_segment_matches_reference(fft_impl):
    """A staged bs16 chain whose azimuth segments transform 8192 points:
    the exponents re-taken at each segment boundary, as the reference
    carries them."""
    rng = np.random.default_rng(4)
    na, nr = 8192, 8
    segments = ((0, True, False, "none"), (1, True, True, "shared"),
                (0, False, True, "full"))
    x = [rand(rng, 1, na, nr) for _ in range(2)]
    args = [rand(rng, nr), rand(rng, nr), rand(rng, na, nr),
            rand(rng, na, nr)]
    kw = dict(segments=segments, residency="staged", fft_impl=fft_impl,
              precision="bs16")
    want = jops.mega_spectral_op(*(jnp.asarray(a) for a in x),
                                 *(jnp.asarray(a) for a in args), **kw)
    got = tops.mega_spectral_op(*(torch.from_numpy(a) for a in x),
                                *(torch.from_numpy(a) for a in args), **kw)
    assert_rounds_where(got, want, "bs16")


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_reduced_long_scene_bs16_matches_live_reference(fft_impl):
    """The 64 x 8192 scene at bs16: fused3 on the CPU gives the live
    reference's peaks within 0.1 dB; fused1 equals it bit for bit."""
    cfg, raw = scene("64x8192")
    tcfg = P.scene_from_dict(dataclasses.asdict(cfg))
    want = np.asarray(jbuild(cfg, "fused3", tune="off",
                             precision="bs16").run(jnp.asarray(raw)))
    kw = dict(device="cpu", fft_impl=fft_impl, precision="bs16")
    got = P.build_pipeline(tcfg, "fused3", **kw).run(torch.from_numpy(raw))
    cmp = jmetrics.compare_pipelines(got.numpy(), want, cfg, jtargets(cfg))
    assert max(cmp["snr_delta_db"]) <= 0.1, cmp["snr_delta_db"]
    assert [(r.row, r.col) for r in cmp["reports_a"]] == \
        [(r.row, r.col) for r in cmp["reports_b"]]
    one = P.build_pipeline(tcfg, "fused1", **kw)
    assert one.steps[0].kernel_kw["residency"] == "staged"
    assert torch.equal(one.run(torch.from_numpy(raw)), got)


# ---------------------------------------------------------------------------
# The residency cut: every slab that fits one block runs resident
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,fft_kw", [((128, 128), dict(n1=8, n2=4,
                                                            n3=4)),
                                          ((2, 8192), None)])
def test_residency_cut_keeps_long_lines_resident(shape, fft_kw):
    """A scene whose slab fits one block, with a range line of three
    factors (128^2 at (8, 4, 4)) or past 4096 points (2 x 8192), compiles
    fused1 to ``vmem`` as the reference's cut does (mega_resident runs the
    long passes on its slab); the kernels' check takes the compiled
    launch and a pinned ``staged``, and the image equals fused3's and the
    pinned staged fused1's."""
    na, nr = shape
    cfg = dataclasses.replace(tscene(128), na=na, nr=nr)
    kw = dict(device="cpu", fft_kw=fft_kw) if fft_kw else dict(device="cpu")
    one = P.build_pipeline(cfg, "fused1", **kw)
    kk = one.steps[0].kernel_kw
    assert kk["residency"] == "vmem"
    assert tops.mega_residency(na, nr) == "vmem"

    segs = tuple(tfft.SegmentSpec(axis=r[0], fwd=r[1], inv=r[2],
                                  filter_mode=r[3],
                                  outer_rank=1) for r in kk["segments"])
    mk = dict(n1=kk["n1"], n2=kk["n2"], n3=kk["n3"],
              fft_impl=kk["fft_impl"], precision=kk["precision"])
    for residency in ("vmem", "staged"):
        tops.check_mega_kernel(tfft.MegaSpec(na, nr, segs,
                                             residency=residency, **mk))
    g = torch.Generator().manual_seed(5)
    raw = torch.complex(torch.randn(na, nr, generator=g),
                        torch.randn(na, nr, generator=g))
    three = P.build_pipeline(cfg, "fused3", **kw).run(raw)
    got = one.run(raw)
    assert torch.equal(got, three)
    staged = P.build_pipeline(cfg, "fused1", residency="staged", **kw)
    assert staged.steps[0].kernel_kw["residency"] == "staged"
    assert torch.equal(staged.run(raw), got)


def test_residency_cut_keeps_fitting_scenes_resident_whatever_the_split():
    """The splits the cut reads (``ops.mega_splits``) no longer change it:
    128^2 at its default split and at (8, 4, 4) both run resident, and the
    cost model prices the same cut; a slab past one block stays staged."""
    segs = ((0, True, False, "none"), (1, True, True, "shared"),
            (0, False, True, "full"))
    assert tops.mega_residency(
        128, 128, splits=tops.mega_splits(128, 128, segs)) == "vmem"
    three = tops.mega_splits(128, 128, segs, n1=8, n2=4, n3=4)
    assert [fs for _, fs in three] == [(16, 8), (8, 4, 4), (16, 8)]
    assert tops.mega_residency(128, 128, splits=three) == "vmem"
    assert tops.mega_splits(128, 128, segs, n1=8, n2=4, n3=4,
                            fft_impl="stockham")[1] == (128, ())
    assert cost.mega_residency(2, 8192) == "vmem"
    assert cost.mega_residency(4, 8192) == "staged"
    assert cost.serve_batch_seconds(2, 8192) > 0


# ---------------------------------------------------------------------------
# The tuner past one block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,karatsuba", FORMS)
def test_tuner_admits_narrow_configs_at_8192(precision, karatsuba):
    """Every form is feasible at N = 8192 (the 16-bit forms' one-stage
    digits fit one block's shared memory) and priced."""
    key = tt.TuneKey.kernel(8192, 16, backend="cpu", device="cpu")
    cfg = tt.KernelConfig(block=8, n1=128, n2=64, karatsuba=karatsuba,
                          precision=precision)
    assert cost.feasible(cfg, key)
    assert 0 < cost.vmem_bytes(cfg, key) <= tops.SMEM_OPTIN_BYTES
    assert 0 < cost.predicted_seconds(cfg, key) < float("inf")
    geom = tops.long_geometry(cfg.apply(tfft.SpectralSpec(
        n=8192, fwd=True, inv=True, filter_mode="shared")))
    assert geom.natural == (precision != "f32")
