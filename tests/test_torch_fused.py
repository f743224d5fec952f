"""repro_torch's paper baselines vs the JAX reference on the CPU: the tiled
transpose, the paper-faithful 8-launch ``fused`` RDA (orientation
tracking in the plan compiler), and the Stockham FFT route
(``fft_impl="stockham"``) through the per-axis op, the megakernel op and
the ``fused3`` / ``fused1`` pipelines. The hand-written CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Inputs come from ``np.random.default_rng(seed)`` (scenes from the
reference's ``simulate_cached``) and go to both packages as numpy arrays.
The JAX side runs as its own tests run it: Pallas in interpret mode on the
CPU. Tolerances: exact for a transpose; 2e-4 x max|want| for the ops (the
reference's own, tests/test_kernels.py); pipelines the same peak pixels
and |dSNR| <= 0.1 dB (the serving gate), with the L2 difference bounded.
"""
import dataclasses
import math

import jax
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
from repro.kernels import fft4step as jfft
from repro.kernels import ops as jops
from repro.kernels.transpose import transpose as jtranspose

import repro_torch.core.sar as P
from repro_torch.core import plan as tplan
from repro_torch.core.sar import rda as trda
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import transpose as ttranspose

F32_TOL = 2e-4
GATE_DB = 0.1
L2_MAX = 1e-5        # measured ~2e-7 for fused and the Stockham pipelines
MODES = ["none", "shared", "full", "outer", "shared_outer"]
DIRS = [(True, False), (False, True), (True, True)]

_cache = {}


def scene(na=128):
    """(reference cfg, targets, raw numpy scene) of the 128-wide test
    scene, square or with ``na`` azimuth lines."""
    if na not in _cache:
        cfg = dataclasses.replace(make_jscene(128), na=na)
        targets = jtargets(cfg)
        raw = np.array(jsimulate_cached(cfg, targets), np.complex64)
        _cache[na] = (cfg, targets, raw)
    return _cache[na]


def tcfg(jcfg):
    return P.scene_from_dict(dataclasses.asdict(jcfg))


def assert_same_focus(got, want, cfg, targets):
    """Same peaks, |dSNR| <= 0.1 dB, L2 bounded; returns the comparison."""
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.isfinite(got).all()
    cmp = jmetrics.compare_pipelines(got, want, cfg, targets)
    assert [(r.row, r.col) for r in cmp["reports_a"]] == \
        [(r.row, r.col) for r in cmp["reports_b"]]
    assert max(cmp["snr_delta_db"]) <= GATE_DB, cmp["snr_delta_db"]
    assert cmp["l2_relative_error"] <= L2_MAX, cmp["l2_relative_error"]
    return cmp


def assert_close(got, want, tol=F32_TOL):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0)


# ---------------------------------------------------------------------------
# The tiled transpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c", [(64, 64), (128, 256), (96, 32),
                                 (96, 40), (100, 36), (7, 5)])
def test_transpose_matches_reference(r, c):
    """The shapes of the reference's own transpose tests (square,
    non-square, ragged against the tile), 2-D and batched, exact."""
    rng = np.random.default_rng(r * 1000 + c)
    x = rng.standard_normal((r, c)).astype(np.float32)
    xb = rng.standard_normal((2, r, c)).astype(np.float32)
    for a in (x, xb):
        got = ttranspose.transpose(torch.from_numpy(a), tile=32).numpy()
        want = np.asarray(jtranspose(jnp.asarray(a), tile=32))
        assert np.array_equal(got, want)
        assert np.array_equal(got, np.swapaxes(a, -1, -2))


def test_transpose_plain_complex_default_tile_and_checks():
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((3, 37, 300))
         + 1j * rng.standard_normal((3, 37, 300))).astype(np.complex64)
    before = ttranspose.TRANSPOSE_LAUNCHES
    got = ttranspose.transpose(torch.from_numpy(z))
    assert got.is_contiguous() and got.dtype == torch.complex64
    assert np.array_equal(got.numpy(), np.swapaxes(z, -1, -2))
    assert ttranspose.TRANSPOSE_LAUNCHES == before     # CPU: no launch
    with pytest.raises(ValueError, match="tile"):
        ttranspose.transpose(torch.from_numpy(z), tile=0)
    with pytest.raises(ValueError, match="shape"):
        ttranspose.transpose(torch.zeros(2, 2, 2, 2))


# ---------------------------------------------------------------------------
# The paper-faithful fused RDA: 8 launches, orientation tracking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na", [128, 256])
def test_fused_matches_live_reference(na):
    """Square and non-square (a square scene would hide a FULL filter
    that is not transposed with the data)."""
    cfg, targets, raw = scene(na)
    want = np.asarray(jbuild(cfg, "fused", tune="off").run(jnp.asarray(raw)))
    got = P.build_pipeline(tcfg(cfg), "fused", device="cpu").run(
        torch.from_numpy(raw)).numpy()
    assert_same_focus(got, want, cfg, targets)


def test_fused_batch_matches_live_reference():
    cfg, targets, raw = scene(128)
    batch = np.stack([raw, raw[::-1].copy() * np.complex64(0.5)])
    want = np.asarray(jbuild(cfg, "fused", tune="off").run(
        jnp.asarray(batch)))
    pipe = P.build_pipeline(tcfg(cfg), "fused", device="cpu")
    got = pipe.run(torch.from_numpy(batch)).numpy()
    for g, w in zip(got, want):
        assert_same_focus(g, w, cfg, targets)
    assert np.array_equal(got[0], pipe.run(torch.from_numpy(raw)).numpy())


def test_fused_dispatches_and_compiled_orientation():
    cfg, _, _ = scene(256)
    pipe = P.build_pipeline(tcfg(cfg), "fused", device="cpu")
    assert P.documented_dispatches("fused") == 8 == pipe.dispatches
    assert jrda.documented_dispatches("fused") == 8
    assert [s.kind for s in pipe.steps].count("transpose") == 4
    spectral = [s for s in pipe.steps if s.kind == "spectral"]
    assert [(s.name, s.phys_axis, s.kernel_kw["axis"], s.filter_mode)
            for s in spectral] == [
        ("range_compression", 1, 1, "shared"),
        ("azimuth_fft", 1, 1, "none"),
        ("azimuth_compression", 1, 1, "full")]
    # the FULL azimuth filter (na, nr) turned with the data: (nr, na)
    h = tplan._built("azimuth_mf", tcfg(cfg), ())[1]
    hr = spectral[2].filter_kw["hr"]
    assert hr.shape == (cfg.nr, cfg.na)
    assert torch.equal(hr, torch.from_numpy(
        np.ascontiguousarray(h.T.real.astype(np.float32))))
    assert spectral[1].kernel_kw["block"] == 8         # a rows launch


@pytest.mark.parametrize("fuse", [False, True, tplan.FUSE_MEGA])
def test_fused_dispatch_count_matches_reference(fuse):
    jfuse = jplan.FUSE_MEGA if fuse == tplan.FUSE_MEGA else fuse
    assert tplan.plan_dispatch_count(trda.plan_fused(), fuse) == \
        jplan.plan_dispatch_count(jrda.plan_fused(), jfuse)
    assert trda.plan_fused() == tplan.plan_from_json(
        jplan.plan_to_json(jrda.plan_fused()))


def test_fused_torch_backend_and_unfused_agree():
    cfg, targets, raw = scene(256)
    x = torch.from_numpy(raw)
    got = P.build_pipeline(tcfg(cfg), "fused", device="cpu").run(x).numpy()
    oracle = P.build_pipeline(tcfg(cfg), "fused", device="cpu",
                              backend="torch").run(x).numpy()
    unfused = P.build_pipeline(tcfg(cfg), "unfused", device="cpu").run(
        x).numpy()
    assert_same_focus(got, oracle, cfg, targets)
    assert_same_focus(got, unfused, cfg, targets)


def _turn(name):
    return tplan.Stage(name, kind="transpose")


@pytest.mark.parametrize("stages,fuse,what", [
    ((_turn("in"), tplan.Stage("az", axis=0, fwd=True),
      tplan.Stage("rg", axis=1, fwd=True, inv=True, filters=("range_mf",)),
      _turn("out")), tplan.FUSE_MEGA, "mega step .* transposed"),
    ((_turn("in"), tplan.Stage("rcmc", kind="sinc_rcmc"), _turn("out")),
     True, "custom stage .* transposed"),
    ((tplan.Stage("rg", axis=1, fwd=True, inv=True, filters=("range_mf",)),
      _turn("in")), True, "ends in transposed"),
])
def test_transposed_sections_refuse_like_reference(stages, fuse, what):
    cfg, _, _ = scene(128)
    plan = tplan.SpectralPlan("t", stages)
    with pytest.raises(ValueError, match=what):
        tplan.compile_plan(plan, tcfg(cfg), device="cpu", fuse=fuse)
    jfuse = jplan.FUSE_MEGA if fuse == tplan.FUSE_MEGA else fuse
    with pytest.raises(ValueError, match="transposed"):
        jplan.compile_plan(jplan.plan_from_json(tplan.plan_to_json(plan)),
                           cfg, fuse=jfuse, tune="off")


# ---------------------------------------------------------------------------
# The Stockham route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8, 128, 4096])
def test_stockham_twiddles_bit_equal_reference_formula(n):
    """Each pass's table against the reference kernel's own float32
    formula (fft4step.py:_fft_stockham), evaluated op by op (under jit
    XLA would contract the products into FMAs)."""
    tw = tfft.stockham_twiddles(n, "cpu")
    cur, passes = n, 0
    while cur > 1:
        radix = 4 if cur % 4 == 0 else 2
        m = cur // radix
        k = jax.lax.broadcasted_iota(jnp.float32, (m, 1), 0)
        th = (-2.0 * math.pi / cur) * k
        want = [jnp.cos(th), jnp.sin(th)]
        if radix == 4:
            w2 = jfft._cmul(*want, *want)
            want += [*w2, *jfft._cmul(*w2, want[0], want[1])]
        got = tw[passes]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(w).ravel())
        cur, passes = m, passes + 1
    assert len(tw) == passes == len(tfft.stockham_radices(n))


def test_stockham_table_interleaves_the_twiddles():
    tab = tfft.stockham_table(32, "cpu").reshape(-1, 2)
    rows = []
    for radix, p in zip(tfft.stockham_radices(32),
                        tfft.stockham_twiddles(32, "cpu")):
        pairs = [torch.stack(p[i:i + 2], 1) for i in range(0, len(p), 2)]
        rows.append(torch.stack(pairs, 1).reshape(-1, 2))
        assert len(p) == (6 if radix == 4 else 2)
    assert torch.equal(tab, torch.cat(rows))
    assert tfft.stockham_radices(32) == (4, 4, 2)
    with pytest.raises(ValueError, match="power of two"):
        tfft.stockham_radices(1)


@pytest.mark.parametrize("fwd,inv", DIRS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [32, 64])
def test_stockham_op_matches_reference(n, axis, fwd, inv):
    """Every filter mode; N = 32 has a radix-2 pass, 64 is radix-4 only."""
    rng = np.random.default_rng(n + 10 * axis + fwd + 2 * inv)
    lines = 6
    shape = (2, lines, n) if axis == 1 else (2, n, lines)
    x = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    for mode in MODES:
        filt = {}
        if mode in ("shared", "shared_outer"):
            filt.update(hr=rng.standard_normal(n).astype(np.float32),
                        hi=rng.standard_normal(n).astype(np.float32))
        if mode == "full":
            filt.update(hr=rng.standard_normal(shape[1:]).astype(np.float32),
                        hi=rng.standard_normal(shape[1:]).astype(np.float32))
        if mode in ("outer", "shared_outer"):
            filt.update(
                u=0.1 * rng.standard_normal((lines, 2)).astype(np.float32),
                v=rng.standard_normal((n, 2)).astype(np.float32))
        kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode,
                  fft_impl="stockham", block=2)
        got = tops.spectral_op(*(torch.from_numpy(a) for a in x),
                               **{k: torch.from_numpy(v)
                                  for k, v in filt.items()}, **kw)
        want = jops.spectral_op(*(jnp.asarray(a) for a in x),
                                **{k: jnp.asarray(v)
                                   for k, v in filt.items()}, **kw)
        assert_close([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("residency", ["vmem", "staged"])
def test_stockham_mega_op_matches_reference(residency):
    """fused1's chain and an inverse-only / forward-only boundary on a
    non-square scene (32 azimuth lines have a radix-2 pass)."""
    rng = np.random.default_rng(17)
    na, nr = 32, 64
    x = [rng.standard_normal((2, na, nr)).astype(np.float32)
         for _ in range(2)]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    chains = [
        (((0, True, False, "none"), (1, True, True, "shared_outer"),
          (0, False, True, "outer")),
         [f(nr), f(nr), 0.1 * f(na, 2), f(nr, 2), 0.1 * f(nr, 2),
          f(na, 2)]),
        (((1, True, False, "full"), (1, False, True, "none"),
          (0, True, True, "shared")), [f(na, nr), f(na, nr), f(na), f(na)]),
    ]
    for segments, args in chains:
        kw = dict(segments=segments, residency=residency,
                  fft_impl="stockham")
        got = tops.mega_spectral_op(*(torch.from_numpy(a) for a in x),
                                    *(torch.from_numpy(a) for a in args),
                                    **kw)
        want = jops.mega_spectral_op(*(jnp.asarray(a) for a in x),
                                     *(jnp.asarray(a) for a in args), **kw)
        assert_close([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("variant", ["fused3", "fused1"])
def test_stockham_pipelines_match_live_reference(variant):
    cfg, targets, raw = scene(128)
    want = np.asarray(jbuild(cfg, variant, tune="off",
                             fft_impl="stockham").run(jnp.asarray(raw)))
    pipe = P.build_pipeline(tcfg(cfg), variant, device="cpu",
                            fft_impl="stockham")
    assert pipe.dispatches == P.documented_dispatches(variant)
    got = pipe.run(torch.from_numpy(raw)).numpy()
    assert_same_focus(got, want, cfg, targets)


def test_stockham_fused1_close_to_stockham_fused3_and_matmul():
    cfg, targets, raw = scene(128)
    x = torch.from_numpy(raw)
    run = lambda v, **kw: P.build_pipeline(  # noqa: E731
        tcfg(cfg), v, device="cpu", **kw).run(x).numpy()
    f1 = run("fused1", fft_impl="stockham")
    f3 = run("fused3", fft_impl="stockham")
    scale = np.abs(f3).max()
    assert np.abs(f1 - f3).max() <= F32_TOL * scale
    staged = run("fused1", fft_impl="stockham", residency="staged")
    assert np.abs(staged - f3).max() <= F32_TOL * scale
    assert_same_focus(f3, run("fused3"), cfg, targets)
