"""The numerics of the CUDA kernels' tensor-core stage, modelled in numpy
on the CPU and held against the JAX reference and ``np.fft``.

The matmul route of ``csrc/spectral_common.cuh`` runs each four-step
contraction on ``mma.sync`` TF32 in the error-compensated 3xTF32 form:
every f32 operand is split into hi = tf32(a) and lo = tf32(a - hi)
(``cvt.rna.tf32.f32``: round to nearest, ties away, 13 low mantissa bits
dropped), and every real product is lo*hi + hi*lo + hi*hi with f32
accumulation. The kernel's ``split_tf32`` (``csrc/tf32_mma.cuh``) adds
half a TF32 ulp to the bits and masks hi, but leaves lo unmasked: the
tensor core reads only the 19 high bits of a TF32 operand, which makes
the lo it multiplies tf32(a - hi) bit for bit. The model splits the same
way on the bits and truncates every operand as the tensor core reads it.
It does the same arithmetic on the same two
stage orientations (A: F1 times the column groups, twiddled; B: the row
groups times F2, as F2 times their transpose) and the inverse's
conjugated input, then:

* 3xTF32 stays within 1e-5 x max|want| of ``np.fft`` in float64 and of the
  reference's f32 four-step (``repro.kernels.fft4step._fft_rows_matmul``
  / ``_fft_cols_matmul``) on the same seeded input;
* one TF32 pass misses ``np.fft`` by more than 1e-5 x max|want|, so the
  card's gate (chip_smoke.py, tests/test_torch_cuda.py) tells the two
  apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import fft4step as jfft

ORACLE_TOL = 1e-5
LINES = 8


HALF_ULP = np.uint32(0x1000)     # half a TF32 ulp, in f32 bits
TF32_MASK = np.uint32(0xFFFFE000)  # the 19 bits a TF32 operand keeps


def bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def tf32(a):
    """``cvt.rna.tf32.f32`` on the bits, low 13 bits zeroed."""
    return ((bits(a) + HALF_ULP) & TF32_MASK).view(np.float32)


def split(a):
    """The kernel's ``split_tf32``: hi = tf32(a), masked; lo the bits of
    the f32 remainder a - hi plus half a TF32 ulp, left unmasked."""
    hi = tf32(a)
    return hi, (bits(a - hi) + HALF_ULP).view(np.float32)


def mma_operand(v):
    """What ``mma.sync`` reads of a TF32 operand: its 19 high bits."""
    return (bits(v) & TF32_MASK).view(np.float32)


def tc_matmul(a, b, passes):
    """a @ b on the modelled tensor core, f32 accumulation: 3 passes
    (lo hi + hi lo + hi hi) or 1 (hi hi)."""
    ah, al = (mma_operand(v) for v in split(a))
    bh, bl = (mma_operand(v) for v in split(b))
    if passes == 1:
        return np.matmul(ah, bh)
    acc = np.matmul(al, bh)
    acc = acc + np.matmul(ah, bl)
    return acc + np.matmul(ah, bh)


def stage(xr, xi, fr, fi, orient, nf, nq, tw, conj_in, passes):
    """One in-place stage over (L, N) lines, as the kernel's ``stage``:
    Y[m, q] = sum_k F[m, k] X[k, q] with X[k, q] at point k * nq + q
    (orientation A) or q * nf + k (B), Y[m, q] back at the same place,
    then times tw[point] with f32 rounding."""
    lines = xr.shape[0]
    if conj_in:
        xi = -xi
    if orient == "A":
        xr3 = xr.reshape(lines, nf, nq)
        xi3 = xi.reshape(lines, nf, nq)
    else:
        xr3 = xr.reshape(lines, nq, nf).transpose(0, 2, 1)
        xi3 = xi.reshape(lines, nq, nf).transpose(0, 2, 1)
    yr = tc_matmul(fr, xr3, passes) + tc_matmul(-fi, xi3, passes)
    yi = tc_matmul(fr, xi3, passes) + tc_matmul(fi, xr3, passes)
    if orient == "B":
        yr, yi = yr.transpose(0, 2, 1), yi.transpose(0, 2, 1)
    yr = np.ascontiguousarray(yr).reshape(lines, -1)
    yi = np.ascontiguousarray(yi).reshape(lines, -1)
    if tw is not None:
        twr, twi = (t.reshape(-1) for t in tw)
        yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
    return yr.astype(np.float32), yi.astype(np.float32)


def model_fft(xr, xi, n, inverse, passes):
    """The kernel's forward or inverse (conj-FFT-conj, 1/N) transform of
    (L, N) lines in natural order, through the modelled stages."""
    n1, n2 = jfft.default_factorization(n)
    f1r, f1i, f2r, f2i, twr, twi = jfft.dft_constants(n1, n2)
    lines = xr.shape[0]
    if not inverse:
        yr, yi = stage(xr, xi, f1r, f1i, "A", n1, n2, (twr, twi), False,
                       passes)
        yr, yi = stage(yr, yi, f2r, f2i, "B", n2, n1, None, False, passes)
        # transposed order s[k1 n2 + k2] = X[k2 n1 + k1] -> natural
        return (yr.reshape(lines, n1, n2).transpose(0, 2, 1).reshape(lines, n),
                yi.reshape(lines, n1, n2).transpose(0, 2, 1).reshape(lines, n))
    # natural -> the transposed order the inverse reads
    sr = xr.reshape(lines, n2, n1).transpose(0, 2, 1).reshape(lines, n)
    si = xi.reshape(lines, n2, n1).transpose(0, 2, 1).reshape(lines, n)
    yr, yi = stage(sr, si, f2r, f2i, "B", n2, n1, (twr, twi), True, passes)
    yr, yi = stage(yr, yi, f1r, f1i, "A", n1, n2, None, False, passes)
    scale = np.float32(1.0 / n)
    return yr * scale, yi * -scale


def reference_fft(xr, xi, n, inverse, axis):
    """The JAX package's f32 four-step on the same lines, rows or cols."""
    spec = jfft.SpectralSpec(n=n, fwd=True, filter_mode="none", inv=False,
                             axis=axis)
    consts = [jnp.asarray(c) for c in jfft.dft_constants(
        *jfft.default_factorization(n))]
    sign = -1.0 if inverse else 1.0
    if axis == 1:
        yr, yi = jfft._fft_rows_matmul(jnp.asarray(xr), jnp.asarray(sign * xi),
                                       consts, spec)
    else:
        yr, yi = jfft._fft_cols_matmul(jnp.asarray(xr.T),
                                       jnp.asarray(sign * xi.T), consts, spec)
        yr, yi = yr.T, yi.T
    yr, yi = np.asarray(yr, np.float64), np.asarray(yi, np.float64)
    if inverse:
        return yr / n, -yi / n
    return yr, yi


def case(n, seed):
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((LINES, n)).astype(np.float32)
    xi = rng.standard_normal((LINES, n)).astype(np.float32)
    return xr, xi


def oracle(xr, xi, inverse):
    z = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    return np.fft.ifft(z, axis=1) if inverse else np.fft.fft(z, axis=1)


def rel_err(got, want):
    """max|got - want| over max|want| (want complex128 or a split pair)."""
    if isinstance(want, tuple):
        want = want[0] + 1j * want[1]
    g = got[0].astype(np.float64) + 1j * got[1].astype(np.float64)
    return float(np.abs(g - want).max() / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # a TF32 ulp at 1
    below, tie = np.float32(1 + 2.0 ** -11 - 2.0 ** -23), np.float32(
        1 + 2.0 ** -11)
    np.testing.assert_array_equal(
        tf32(np.array([below, tie, -tie, one + ulp], np.float32)),
        np.array([1.0, 1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -10],
                 np.float32))
    a = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = tf32(a)
    lo = tf32(a - hi)
    assert np.all(np.abs(a - hi) <= np.abs(a) * 2.0 ** -11)
    # hi + lo keeps ~21 bits: the split is what makes 3 passes f32-exact
    assert np.all(np.abs(a - (hi + lo)) <= np.abs(a) * 2.0 ** -21)


def test_split_as_the_tensor_core_reads_it_is_rna_rounding():
    """hi is tf32(a), and the unmasked lo, read through its 19 high bits,
    is tf32(a - hi) bit for bit: the kernel's split is the rna split."""
    rng = np.random.default_rng(1)
    a = np.concatenate([
        rng.standard_normal(100_000) * 10.0 ** rng.integers(-30, 30, 100_000),
        [0.0, -0.0, 1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -23,
         2.0 ** -126, 1e-40, -3.0e38]]).astype(np.float32)
    hi, lo = split(a)
    np.testing.assert_array_equal(bits(hi), bits(tf32(a)))
    np.testing.assert_array_equal(bits(mma_operand(lo)),
                                  bits(tf32(a - hi)))
    np.testing.assert_array_equal(bits(split(-a)[0]), bits(-hi))


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 128, 4096])
def test_three_pass_split_keeps_f32_accuracy(n, inverse, axis):
    xr, xi = case(n, seed=n + int(inverse))
    got = model_fft(xr, xi, n, inverse, passes=3)
    assert rel_err(got, oracle(xr, xi, inverse)) <= ORACLE_TOL
    assert rel_err(got, reference_fft(xr, xi, n, inverse, axis)) <= ORACLE_TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 128, 4096])
def test_one_tf32_pass_misses_the_gate(n, inverse):
    xr, xi = case(n, seed=n + int(inverse))
    three = rel_err(model_fft(xr, xi, n, inverse, passes=3),
                    oracle(xr, xi, inverse))
    one = rel_err(model_fft(xr, xi, n, inverse, passes=1),
                  oracle(xr, xi, inverse))
    assert one > ORACLE_TOL > three
