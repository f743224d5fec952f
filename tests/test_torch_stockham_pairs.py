"""The schedule the CUDA kernels run the Stockham passes in
(``fft4step.stockham_pairs``, followed by ``csrc/spectral_common.cuh``):
passes paired on registers, one exchange through shared memory a pair.

The plan is run here group by group with the plain float32 arithmetic of
``fft4step._fft_stockham`` (the kernels' butterflies) and held
``torch.equal`` to it, forward and with the inverse's conjugated input,
for every power of two the kernels take; it is held to the JAX package's
Stockham route (``repro.kernels.ops.spectral_op(..., fft_impl="stockham")``,
Pallas in interpret mode on the CPU) within 2e-4 x max|want|, the
reference's own tolerance (tests/test_kernels.py). Inputs come from
``np.random.default_rng(seed)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fft4step as tfft

SIZES = [2 ** k for k in range(1, 13)]
TURNAROUND = [16, 256, 4096]     # powers of 16: one G in every step
F32_TOL = 2e-4


def _butterfly(a, regs, radix, tw, k):
    """One radix-``radix`` butterfly of every group, in place on registers
    ``regs`` of ``a`` (re, im of shape (lines, groups, G)), with the
    twiddles of index k (groups,): the float operations of
    ``_fft_stockham``."""
    ar, ai = a[0][..., regs[0]], a[1][..., regs[0]]
    br, bi = a[0][..., regs[1]], a[1][..., regs[1]]
    if radix == 2:
        w1r, w1i = tw[0][k], tw[1][k]
        outs = [(ar + br, ai + bi), tfft._cmul(ar - br, ai - bi, w1r, w1i)]
    else:
        cr, ci = a[0][..., regs[2]], a[1][..., regs[2]]
        dr, di = a[0][..., regs[3]], a[1][..., regs[3]]
        apc_r, apc_i = ar + cr, ai + ci
        amc_r, amc_i = ar - cr, ai - ci
        bpd_r, bpd_i = br + dr, bi + di
        bmd_r, bmd_i = br - dr, bi - di
        outs = [(apc_r + bpd_r, apc_i + bpd_i),
                tfft._cmul(amc_r + bmd_i, amc_i - bmd_r, tw[0][k], tw[1][k]),
                tfft._cmul(apc_r - bpd_r, apc_i - bpd_i, tw[2][k], tw[3][k]),
                tfft._cmul(amc_r - bmd_i, amc_i + bmd_r, tw[4][k], tw[5][k])]
    for j, (o_r, o_i) in zip(regs, outs):
        a[0][..., j] = o_r
        a[1][..., j] = o_i


def run_plan(xr, xi, conj_in=False):
    """The n-point Stockham FFT of every line of (lines, n) through
    ``stockham_pairs``: per step, gather each group's inputs into its
    registers, run the step's passes on them, scatter the outputs."""
    n = xr.shape[1]
    tws = tfft.stockham_twiddles(n, "cpu")
    yr, yi = xr, (-xi if conj_in else xi)
    for step in tfft.stockham_pairs(n):
        a = [yr[:, step.inputs].clone(), yi[:, step.inputs].clone()]
        r1 = step.radices[0]
        r2 = step.radices[1] if len(step.radices) == 2 else 1
        for b in range(r2):
            _butterfly(a, [r2 * r + b for r in range(r1)], r1,
                       tws[step.passes[0]], step.twiddles[0][:, b])
        if r2 > 1:
            for t in range(r1):
                _butterfly(a, [r2 * t + r for r in range(r2)], r2,
                           tws[step.passes[1]], step.twiddles[1][:, t])
        yr, yi = torch.empty_like(yr), torch.empty_like(yi)
        yr[:, step.outputs] = a[0]
        yi[:, step.outputs] = a[1]
    return yr, yi


def lines(n, count=3, seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.standard_normal((count, n)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("conj_in", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_plan_equals_plain_stockham(n, conj_in):
    xr, xi = (torch.from_numpy(a) for a in lines(n))
    want = tfft._fft_stockham(xr, -xi if conj_in else xi, 1)
    got = run_plan(xr, xi, conj_in)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", SIZES)
def test_plan_steps_cover_every_pass_and_point(n):
    steps = tfft.stockham_pairs(n)
    passes = [p for s in steps for p in s.passes]
    assert passes == list(range(len(tfft.stockham_radices(n))))
    assert tuple(r for s in steps for r in s.radices) == \
        tfft.stockham_radices(n)
    assert all(len(s.radices) == 2 for s in steps[:-1])
    tws = tfft.stockham_twiddles(n, "cpu")
    for s in steps:
        big = int(np.prod(s.radices))
        assert s.inputs.shape == s.outputs.shape == (n // big, big)
        for idx in (s.inputs, s.outputs):     # each point once a step
            assert torch.equal(idx.reshape(-1).sort().values,
                               torch.arange(n))
        for p, k in zip(s.passes, s.twiddles):
            assert 0 <= int(k.min()) and int(k.max()) < tws[p][0].numel()
    # the first step reads coalesced runs: group g takes g + m * n / G
    g = torch.arange(n // steps[0].inputs.shape[1])[:, None]
    assert torch.equal(steps[0].inputs % (n // steps[0].inputs.shape[1]),
                       g.expand_as(steps[0].inputs))


@pytest.mark.parametrize("n", TURNAROUND)
def test_forward_ends_where_the_inverse_starts(n):
    """The turnaround in registers: the forward's last step leaves group g
    holding exactly the points the inverse's first step of group g reads,
    output kR1 r'' + t in register kR2 t + r''."""
    steps = tfft.stockham_pairs(n)
    first, last = steps[0], steps[-1]
    assert first.radices == last.radices
    r1, r2 = last.radices
    m = torch.arange(r1 * r2)
    assert torch.equal(last.outputs[:, r2 * (m % r1) + m // r1], first.inputs)


@pytest.mark.parametrize("n", [32, 64, 128, 1024, 2048])
def test_other_sizes_exchange_between_transforms(n):
    """Where the last step's group differs from the first's, the sets
    differ: the kernels write the forward's outputs (filtered in
    registers) to shared memory, and the inverse reads its own groups."""
    steps = tfft.stockham_pairs(n)
    assert steps[0].inputs.shape != steps[-1].outputs.shape


@pytest.mark.parametrize("n", [16, 128, 1024])
def test_plan_matches_jax_reference(n):
    xr, xi = lines(n, count=4, seed=7)
    want = jops.spectral_op(jnp.asarray(xr), jnp.asarray(xi), axis=1,
                            fwd=True, inv=False, fft_impl="stockham",
                            block=4)
    got = run_plan(torch.from_numpy(xr), torch.from_numpy(xi))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= F32_TOL * scale
