"""repro_torch kernels vs the JAX reference: DFT constants, the plain
version of the fused spectral op against ``repro.kernels.ops.spectral_op``
(Pallas interpret mode) and the ``torch.fft`` oracle, and the bs16 codec.
The hand-written CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as numpy arrays. Tolerances are the reference's own
(tests/test_kernels.py): 2e-4 x max|want| at f32, 5e-2 at bf16.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import fft4step as jfft
from repro.kernels import ops as jops
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = 2e-4
BF16_TOL = 5e-2

MODES = ["none", "shared", "full", "outer", "shared_outer"]
# fwd/inv per mode as the RDA launches use them: the azimuth FFT (none),
# range compression (shared), azimuth compression (full / outer: inverse
# only) and the fused range + RCMC launch (shared_outer)
MODE_DIRS = {"none": (True, False), "shared": (True, True),
             "full": (False, True), "outer": (False, True),
             "shared_outer": (True, True)}


def assert_close(got, want, tol=F32_TOL):
    gr, gi = (np.asarray(g) for g in got)
    wr, wi = (np.asarray(w) for w in want)
    scale = max(float(np.abs(wr).max()), float(np.abs(wi).max()), 1e-30)
    np.testing.assert_allclose(gr, wr, atol=tol * scale, rtol=0)
    np.testing.assert_allclose(gi, wi, atol=tol * scale, rtol=0)


def make_case(seed, mode, axis, n, batch, lines, rank=2):
    """x (numpy, split re/im) plus the mode's filter kwargs."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    scene = (lines, n) if axis == 1 else (n, lines)
    shape = scene if batch is None else (batch, *scene)
    x = (rand(*shape), rand(*shape))
    filt = {}
    if mode in ("shared", "shared_outer"):
        filt.update(hr=rand(n), hi=rand(n))
    if mode == "full":
        filt.update(hr=rand(*scene), hi=rand(*scene))
    if mode in ("outer", "shared_outer"):
        filt.update(u=rand(lines, rank), v=rand(n, rank))
    return x, filt


def run_ref(x, filt, **kw):
    return jops.spectral_op(jnp.asarray(x[0]), jnp.asarray(x[1]),
                            **{k: jnp.asarray(v) for k, v in filt.items()},
                            **kw)


def run_port(x, filt, device="cpu", plain=False, **kw):
    fn = tops.spectral_op_plain if plain else tops.spectral_op
    t = {k: torch.from_numpy(v).to(device) for k, v in filt.items()}
    return fn(torch.from_numpy(x[0]).to(device),
              torch.from_numpy(x[1]).to(device), **t, **kw)


def to_np(pair):
    return tuple(p.cpu().numpy() for p in pair)


# ---------------------------------------------------------------------------
# Host-side constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << p for p in range(4, 13)])
def test_dft_constants_match_reference(n):
    fs = tfft.default_factorization(n)
    assert fs == jfft.default_factorization(n)
    mine, theirs = tfft.dft_constants(*fs), jfft.dft_constants(*fs)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_three_factor_split_matches_reference():
    for n in (32768, 1 << 18):
        assert tfft.default_factorization(n) == jfft.default_factorization(n)
        assert (tfft.SpectralSpec(n=n, fwd=True, filter_mode="none",
                                  inv=False).factors()
                == jfft.SpectralSpec(n=n, fwd=True, filter_mode="none",
                                     inv=False).factors())


def test_precision_policy_matches_reference():
    assert sorted(tfft.PRECISIONS) == sorted(jfft.PRECISIONS)
    for name, p in tfft.PRECISIONS.items():
        q = jfft.PRECISIONS[name]
        assert (p.dtype, p.block_scaled) == (q.dtype, q.block_scaled)
    assert tfft.resolve_precision(None).name == "f32"
    with pytest.raises(ValueError):
        tfft.resolve_precision("f8")


# ---------------------------------------------------------------------------
# The plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_spectral_plain_matches_reference(mode, axis, n, batch):
    fwd, inv = MODE_DIRS[mode]
    x, filt = make_case(n + batch, mode, axis, n, batch, lines=6)
    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=4)
    want = run_ref(x, filt, **kw)
    got = to_np(run_port(x, filt, **kw))
    assert got[0].shape == x[0].shape
    assert_close(got, want)


@pytest.mark.parametrize("fwd,inv", [(True, False), (False, True),
                                     (True, True), (False, False)])
@pytest.mark.parametrize("axis", [0, 1])
def test_spectral_directions_match_reference(fwd, inv, axis):
    x, filt = make_case(3, "shared_outer", axis, 128, None, lines=5)
    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode="shared_outer",
              block=4)
    assert_close(to_np(run_port(x, filt, **kw)), run_ref(x, filt, **kw))


@pytest.mark.parametrize("mode", MODES)
def test_spectral_plain_matches_torch_fft_oracle(mode):
    n, lines = 256, 7
    fwd, inv = MODE_DIRS[mode]
    x, filt = make_case(11, mode, 1, n, None, lines)
    got = to_np(run_port(x, filt, axis=1, fwd=fwd, inv=inv,
                         filter_mode=mode, block=8))
    kw = {}
    if "hr" in filt:
        kw.update(hr=filt["hr"], hi=filt["hi"])
    if "u" in filt:
        kw.update(u=filt["u"], v=filt["v"])
    want = to_np(tref.spectral_ref(*x, axis=1, fwd=fwd, inv=inv, **kw))
    assert_close(got, want)


def test_ragged_lines_and_padding():
    # 13 lines with block 8 pads to 16 and crops back, both layouts
    for axis in (0, 1):
        x, filt = make_case(5, "full", axis, 64, 2, lines=13)
        kw = dict(axis=axis, fwd=True, inv=True, filter_mode="full", block=8)
        got = to_np(run_port(x, filt, **kw))
        assert got[0].shape == x[0].shape
        assert_close(got, run_ref(x, filt, **kw))


@pytest.mark.parametrize("precision,tol", [("bf16", BF16_TOL),
                                           ("f16", BF16_TOL),
                                           ("bs16", BF16_TOL)])
def test_reduced_precisions_match_reference(precision, tol):
    x, filt = make_case(17, "shared", 1, 512, None, lines=4)
    kw = dict(axis=1, fwd=True, inv=True, filter_mode="shared", block=4,
              precision=precision)
    assert_close(to_np(run_port(x, filt, **kw)), run_ref(x, filt, **kw),
                 tol=tol)


# The plain version rounds each contraction's operands where the reference
# does, so at 16 bits the two differ only in f32 accumulation order, far
# inside this tolerance at these sizes; an inverse on the swapped split
# (n2, n1) rounds other values and misses it (the test after next).
ROUNDING_TOL = 5e-5


@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
@pytest.mark.parametrize("n1,n2,axis", [(16, 8, 1), (16, 8, 0), (8, 16, 1),
                                        (32, 16, 0)])
def test_narrow_precisions_round_where_the_reference_does(precision, n1, n2,
                                                          axis):
    x, filt = make_case(17, "shared", axis, n1 * n2, 2, lines=5)
    kw = dict(axis=axis, fwd=True, inv=True, filter_mode="shared", block=4,
              precision=precision, n1=n1, n2=n2)
    assert_close(to_np(run_port(x, filt, **kw)), run_ref(x, filt, **kw),
                 tol=ROUNDING_TOL)


@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
def test_a_swapped_inverse_misses_the_rounding_tolerance(precision,
                                                         monkeypatch):
    """The check above tells rounding orders apart: the plain version with
    its inverse on the swapped split (n2, n1), as the kernels' f32 inverse
    runs it, misses ROUNDING_TOL by more than three times."""
    run = tfft._run_fft

    def swapped(xr, xi, consts, spec, inverse):
        if inverse:
            fs = spec.factors()[::-1]
            spec = dataclasses.replace(spec, n1=fs[0], n2=fs[1])
            consts = tfft.device_constants(fs, str(xr.device))
        return run(xr, xi, consts, spec, inverse)

    monkeypatch.setattr(tfft, "_run_fft", swapped)
    x, filt = make_case(17, "shared", 1, 128, 2, lines=5)
    kw = dict(axis=1, fwd=True, inv=True, filter_mode="shared", block=4,
              precision=precision, n1=16, n2=8)
    with pytest.raises(AssertionError):
        assert_close(to_np(run_port(x, filt, **kw)), run_ref(x, filt, **kw),
                     tol=3 * ROUNDING_TOL)


@pytest.mark.parametrize("opt", [dict(karatsuba=True),
                                 dict(fft_impl="stockham"),
                                 dict(n1=16, n2=4), dict(n1=128, n2=8)])
def test_options_match_torch_fft(opt):
    n = opt.get("n1", 32) * opt.get("n2", 16)
    x, _ = make_case(19, "none", 0, n, None, lines=4)
    got = to_np(tops.fft_cols(torch.from_numpy(x[0]),
                              torch.from_numpy(x[1]), block=4, **opt))
    assert_close(got, to_np(tref.fft_ref(*x, axis=0)))


def test_three_factor_fft_matches_torch_fft():
    x, _ = make_case(23, "none", 1, 32768, None, lines=2)
    got = to_np(tops.fft_rows(torch.from_numpy(x[0]),
                              torch.from_numpy(x[1]), block=2))
    assert_close(got, to_np(tref.fft_ref(*x, axis=1)))


def test_convenience_entry_points_match_reference():
    rng = np.random.default_rng(29)
    na, nr = 64, 32
    xr, xi = (rng.standard_normal((na, nr)).astype(np.float32)
              for _ in range(2))
    h = rng.standard_normal((2, nr)).astype(np.float32)
    u, v = (rng.standard_normal(na).astype(np.float32),
            rng.standard_normal(nr).astype(np.float32))
    t = torch.from_numpy
    j = jnp.asarray
    pairs = [
        (tops.fused_fft_mult_ifft_rows(t(xr), t(xi), t(h[0]), t(h[1])),
         jops.fused_fft_mult_ifft_rows(j(xr), j(xi), j(h[0]), j(h[1]))),
        (tops.fused_rcmc_rows(t(xr), t(xi), t(u), t(v)),
         jops.fused_rcmc_rows(j(xr), j(xi), j(u), j(v))),
        (tops.fused_rc_rcmc_rows(t(xr), t(xi), t(h[0]), t(h[1]), t(u), t(v)),
         jops.fused_rc_rcmc_rows(j(xr), j(xi), j(h[0]), j(h[1]), j(u),
                                 j(v))),
        (tops.ifft_rows(t(xr), t(xi)), jops.ifft_rows(j(xr), j(xi))),
        (tops.fft_cols(t(xr), t(xi)), jops.fft_cols(j(xr), j(xi))),
        (tops.ifft_cols(t(xr), t(xi)), jops.ifft_cols(j(xr), j(xi))),
        (tops.fused_mult_ifft_cols(t(xr), t(xi), t(xr), t(xi)),
         jops.fused_mult_ifft_cols(j(xr), j(xi), j(xr), j(xi))),
        (tops.fused_mult_ifft_cols_outer(t(xr), t(xi), t(v), t(u)),
         jops.fused_mult_ifft_cols_outer(j(xr), j(xi), j(v), j(u))),
    ]
    for got, want in pairs:
        assert_close(to_np(got), want)


# ---------------------------------------------------------------------------
# The bs16 codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mag", [-60, -3, 0, 17, 60])
@pytest.mark.parametrize("axis", [0, 1])
def test_bs16_codec_matches_reference(mag, axis):
    r = np.random.default_rng(mag + 100)
    scale = np.float32(2.0) ** np.float32(mag)
    xr = (r.standard_normal((2, 4, 32)) * scale).astype(np.float32)
    xi = (r.standard_normal((2, 4, 32)) * scale).astype(np.float32)
    xi[0, 1] = 0.0
    xr[0, 1] = 0.0                          # an all-zero line
    jexp = jfft.line_exponents(jnp.asarray(xr), jnp.asarray(xi), axis)
    texp = tfft.line_exponents(torch.from_numpy(xr), torch.from_numpy(xi),
                               axis)
    np.testing.assert_array_equal(texp.numpy(), np.asarray(jexp))
    sr, si = tfft.remove_exponents(torch.from_numpy(xr),
                                   torch.from_numpy(xi), texp)
    jsr, jsi = jfft.remove_exponents(jnp.asarray(xr), jnp.asarray(xi), jexp)
    np.testing.assert_array_equal(sr.numpy(), np.asarray(jsr))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
    rr, ri = tfft.apply_exponents(sr, si, texp)
    np.testing.assert_array_equal(rr.numpy(), xr)
    np.testing.assert_array_equal(ri.numpy(), xi)
    e = torch.arange(-126, 127, dtype=torch.float32)
    assert torch.equal(tfft._pow2(e), torch.ldexp(torch.ones_like(e), e))


# ---------------------------------------------------------------------------
# What the CUDA kernel takes (checked in Python, before any launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,split", [
    (dict(precision="bf16"), (64, 64)),
    (dict(precision="bs16"), (64, 64)),
    (dict(karatsuba=True), (64, 64)),
    (dict(fft_impl="bluestein"), None),
    (dict(n=8192), (128, 64)), (dict(n=32768), (32, 32, 32)),
    (dict(n=8192, precision="bf16"), (128, 64)),
    (dict(n=8192, karatsuba=True), (128, 64))])
def test_kernel_refuses_what_it_does_not_take(kw, split):
    """The matmul route takes bf16, bs16 and Karatsuba at N = 4096 and
    past it (the split it returns is the four-step's: two factors at
    8192, three at 32768); an unknown route stays refused, naming its
    ROADMAP queue."""
    spec = dict(n=4096, fwd=True, filter_mode="none", inv=False)
    spec.update(kw)
    if split is None:
        with pytest.raises(ValueError, match="ROADMAP"):
            tops.check_kernel_spec(tfft.SpectralSpec(**spec))
    else:
        assert tops.check_kernel_spec(tfft.SpectralSpec(**spec)) == split


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n,axis", [(16, 1), (4096, 1), (4096, 0), (2048, 0)])
def test_kernel_tile_fits_the_block(n, axis, fft_impl):
    tile, threads = tops.kernel_tile(n, axis, fft_impl)
    smem = tile * n * 8
    if fft_impl == "stockham":
        # 16 points a thread in registers, 32 (two groups) in the 4-column
        # tile at N = 4096; at most 512 threads (128 registers a thread)
        per = 32 if (n, axis) == (4096, 0) else 16
        assert tops.stockham_per_thread(tile * n, n) == per
        assert tile * n == threads * per
        assert threads <= tops.STOCKHAM_THREADS == 512
    else:
        # the tensor-core stage: 16 points a thread a round (one task of
        # 4 m16n8 tiles a warp), at most two rounds, 256..512 threads, F1
        # and F2 in shared memory beside the tile
        assert tile * n <= threads * 32 and 256 <= threads <= 512
        smem += tops.dft_smem_bytes(*tfft.default_factorization(n))
    assert threads % 32 == 0
    assert smem <= 227 * 1024                  # shared memory of one block
    assert tops.check_kernel_spec(tfft.SpectralSpec(
        n=n, fwd=True, filter_mode="none", inv=False)) \
        == tfft.default_factorization(n)


@pytest.mark.parametrize("n,axis", [(2, 1), (16, 0), (128, 1), (128, 0),
                                    (2048, 0), (4096, 1), (4096, 0)])
def test_staged_tile_fills_the_stockham_block(n, axis):
    # mega_staged runs every phase on one 512-thread block shape: a tile
    # holds 16 points a thread, or 32 in the one wide tile op the kernels
    # build (4 columns at N = 4096); the matmul route keeps its own tile
    tile = tops.staged_tile(n, 8192, "stockham", n, 1, axis)
    per = tops.stockham_per_thread(tile * n, n)
    assert per == (32 if (n, axis) == (4096, 0) else 16)
    assert tile * n == tops.STOCKHAM_THREADS * per
    assert tile >= tops.kernel_tile(n, axis, "stockham")[0]
    assert tops.staged_tile(n, 3, "stockham", n, 1, axis) == min(tile, 3)
    n1, n2 = tfft.default_factorization(n)[:2]
    assert tops.staged_tile(n, 8192, "matmul", n1, n2, axis) == max(
        1, tops.STAGED_TILE_POINTS // n)


def test_cpu_tensors_never_launch():
    before = tops.SPECTRAL_LAUNCHES
    x, filt = make_case(1, "shared", 1, 64, None, lines=4)
    run_port(x, filt, axis=1, filter_mode="shared")
    assert tops.SPECTRAL_LAUNCHES == before


def test_fma32_rounds_once():
    """fma32 is the kernels' __fmaf_rn: one rounding of the exact a*b + c,
    also where rounding the float64 sum to float32 would round twice (a
    float32 tie after the float64 sum lost the bits below it)."""
    a = torch.tensor([1 - 2 ** -23, -(1 - 2 ** -23), 3.0, 0.0])
    b = torch.tensor([2 ** -24 * (1 + 2 ** -23)] * 2 + [0.5, 7.0])
    c = torch.tensor([1 + 2 ** -23, -(1 + 2 ** -23), -1.5, -2.0])
    got = tfft.fma32(a, b, c)
    assert got.tolist() == [1 + 2 ** -23, -(1 + 2 ** -23), 0.0, -2.0]
    twice = (a.double() * b.double() + c.double()).float()
    assert twice[0] != got[0]          # the case that needs rounding to odd
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                                * 2.0 ** rng.integers(-20, 20, 4096))
               for _ in range(3))
    from fractions import Fraction
    got = tfft.fma32(a, b, c)
    inf = np.float32(np.inf)
    for i in range(0, 4096, 64):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(c[i])))
        g = np.float32(got[i])
        near = [Fraction(float(np.nextafter(g, d))) for d in (inf, -inf)]
        assert all(abs(Fraction(float(g)) - exact) <= abs(x - exact)
                   for x in near)


@pytest.mark.parametrize("axis", [0, 1])
def test_outer_phase_is_the_kernels_fma_chain(axis):
    rng = np.random.default_rng(5 + axis)
    lines, n, rank = 7, 16, 3
    u = torch.from_numpy(rng.standard_normal(
        (lines, rank) if axis == 1 else (rank, lines)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (rank, n) if axis == 1 else (n, rank)).astype(np.float32))
    got = tfft.outer_phase(u, v, axis)
    want = torch.zeros(got.shape)
    for q in range(rank):
        a, b = (u[:, q, None], v[None, q, :]) if axis == 1 \
            else (v[:, q, None], u[None, q, :])
        want = tfft.fma32(a.expand(got.shape), b.expand(got.shape), want)
    assert torch.equal(got, want)
    ref = (u @ v if axis == 1 else v @ u).double()
    assert float((got.double() - ref).abs().max()) <= 4e-6 * float(
        ref.abs().max())
