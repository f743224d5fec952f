"""The port's ``core.fusion`` (``SpectralPipeline``, ``fft_conv``) and
``kernels.ref.transpose_ref`` against the live reference on the same numpy
inputs, on the CPU:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fusion.py

Every filter mode, rows and columns, forward / inverse / both, both FFT
routes; each side on both of its backends (the reference's ``pallas`` in
interpret mode and ``xla``, the port's ``kernel`` — the plain version on a
CPU tensor — and ``torch``), every pair within 2e-4 x max|want|, the
reference's kernel tolerance (tests/test_kernels.py). The Stockham
route's cases run from tests/test_torch_fusion_stockham.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as ref_fusion
from repro.kernels import ref as ref_ref
from repro_torch.core import BACKEND_KERNEL, BACKEND_TORCH
from repro_torch.core import SpectralPipeline, fft_conv
from repro_torch.kernels import ops, ref

TOL = 2e-4
N, LINES = 64, 8
MODES = ["none", "shared", "full", "outer", "shared_outer"]
DIRS = [(True, False), (False, True), (True, True)]


def inputs(seed, mode, axis, n=N, lines=LINES, rank=2):
    rng = np.random.default_rng(seed)
    scene = (lines, n) if axis == 1 else (n, lines)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = (rand(*scene), rand(*scene))
    filt = {}
    if mode in ("shared", "shared_outer"):
        filt.update(hr=rand(n), hi=rand(n))
    if mode == "full":
        filt.update(hr=rand(*scene), hi=rand(*scene))
    if mode in ("outer", "shared_outer"):
        filt.update(u=rand(lines, rank), v=rand(n, rank))
    return x, filt


def on_jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def on_torch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def assert_close(got, want, tol=TOL):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (err, scale)


def check_against_reference(fft_impl, axis, mode, fwd, inv):
    """One case on both backends of each side, every pair within TOL."""
    (xr, xi), filt = inputs(7 * axis + MODES.index(mode), mode, axis)
    kw = dict(fwd=fwd, inv=inv, filter_mode=mode, axis=axis,
              fft_impl=fft_impl)
    want = {"pallas": ref_fusion.SpectralPipeline(**kw)(
        jnp.asarray(xr), jnp.asarray(xi), **on_jax(filt))}
    # the reference's oracle broadcasts the shared vector for 'shared'
    # alone: on columns it refuses 'shared_outer' (see the test below)
    if not (mode == "shared_outer" and axis == 0):
        want["xla"] = ref_fusion.SpectralPipeline(backend="xla", **kw)(
            jnp.asarray(xr), jnp.asarray(xi), **on_jax(filt))
    got = {b: SpectralPipeline(backend=b, **kw)(
        torch.from_numpy(xr), torch.from_numpy(xi), **on_torch(filt))
        for b in (BACKEND_KERNEL, BACKEND_TORCH)}
    for g in got.values():
        for w in want.values():
            assert_close(g, w)


@pytest.mark.parametrize("fwd,inv", DIRS, ids=["fwd", "inv", "fwd_inv"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axis", [1, 0], ids=["rows", "cols"])
def test_spectral_pipeline_matches_reference(axis, mode, fwd, inv):
    """The matmul route (the Stockham route's cases are in
    tests/test_torch_fusion_stockham.py, a file of their own so that the
    reference's interpret mode holds no one worker for long)."""
    check_against_reference("matmul", axis, mode, fwd, inv)


def test_reference_oracle_refuses_shared_outer_on_columns():
    """A finding about the reference: its ``xla`` backend broadcasts the
    (n,) shared vector for 'shared' only, so 'shared_outer' on columns
    raises there; the port's torch backend broadcasts it and agrees with
    the reference's kernel."""
    (xr, xi), filt = inputs(3, "shared_outer", 0)
    kw = dict(filter_mode="shared_outer", axis=0)
    with pytest.raises((TypeError, ValueError)):
        ref_fusion.SpectralPipeline(backend="xla", **kw)(
            jnp.asarray(xr), jnp.asarray(xi), **on_jax(filt))
    want = ref_fusion.SpectralPipeline(**kw)(jnp.asarray(xr),
                                             jnp.asarray(xi), **on_jax(filt))
    got = SpectralPipeline(backend=BACKEND_TORCH, **kw)(
        torch.from_numpy(xr), torch.from_numpy(xi), **on_torch(filt))
    assert_close(got, want)


@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
def test_compute_dtype_is_the_alias_of_precision(precision):
    (xr, xi), filt = inputs(11, "shared", 1)
    x, f = (torch.from_numpy(xr), torch.from_numpy(xi)), on_torch(filt)
    kw = dict(filter_mode="shared", fft_impl="stockham")
    a = SpectralPipeline(precision=precision, **kw)(*x, **f)
    b = SpectralPipeline(compute_dtype=precision, **kw)(*x, **f)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    want = ref_fusion.SpectralPipeline(compute_dtype=precision, **kw)(
        jnp.asarray(xr), jnp.asarray(xi), **on_jax(filt))
    # the 16-bit forms against the reference's interpret mode at its
    # reduced-precision bound (tests/test_kernels.py: 5e-2 for bf16)
    assert_close(a, want, tol=5e-2)


def test_spectral_pipeline_has_no_interpret_mode():
    fields = {f.name for f in dataclasses.fields(SpectralPipeline)}
    assert "interpret" not in fields
    assert {"precision", "compute_dtype", "karatsuba", "fft_impl",
            "block"} <= fields
    with pytest.raises(ValueError):
        SpectralPipeline(backend="pallas")


def test_kernel_backend_is_one_spectral_op_call(monkeypatch):
    """The kernel backend makes exactly one ``ops.spectral_op`` call (one
    launch on a CUDA tensor); the torch backend makes none."""
    calls = []
    real = ops.spectral_op

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "spectral_op", spy)
    (xr, xi), filt = inputs(5, "full", 1)
    x, f = (torch.from_numpy(xr), torch.from_numpy(xi)), on_torch(filt)
    SpectralPipeline(filter_mode="full")(*x, **f)
    assert len(calls) == 1 and calls[0]["filter_mode"] == "full"
    SpectralPipeline(filter_mode="full", backend=BACKEND_TORCH)(*x, **f)
    assert len(calls) == 1
    fft_conv(x[0], f["hr"][0], f["hi"][0])
    assert len(calls) == 2 and calls[1]["filter_mode"] == "shared"


@pytest.mark.parametrize("n", [64, 256])
def test_fft_conv_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((6, n)).astype(np.float32)
    k = np.fft.fft(rng.standard_normal(n))
    kr, ki = k.real.astype(np.float32), k.imag.astype(np.float32)
    want = ref_fusion.fft_conv(jnp.asarray(x), jnp.asarray(kr),
                               jnp.asarray(ki))
    want_xla = ref_fusion.fft_conv(jnp.asarray(x), jnp.asarray(kr),
                                   jnp.asarray(ki), backend="xla")
    for backend in (BACKEND_KERNEL, BACKEND_TORCH):
        got = fft_conv(torch.from_numpy(x), torch.from_numpy(kr),
                       torch.from_numpy(ki), backend=backend)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert_close([got], [want])
        assert_close([got], [want_xla])
    # a real circular convolution: numpy's, in float64
    circ = np.real(np.fft.ifft(np.fft.fft(x, axis=1) * k, axis=1))
    assert_close([got], [circ])


@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 6)])
def test_transpose_ref_matches_reference(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = ref.transpose_ref(torch.from_numpy(x))
    if len(shape) == 2:
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref_ref.transpose_ref(
                                          jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(x, -1, -2))
