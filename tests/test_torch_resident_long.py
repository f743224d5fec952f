"""The resident megakernel past one block (``mega_resident`` with lines of
8192 and 16384 points, three-factor splits and ``batch_block`` scenes a
block) on the CPU: the port's plain version at ``residency="vmem"``
against the JAX reference's ``mega_spectral_op(..., residency="vmem",
interpret=True)``, the residency cut against the reference's, the
kernels' check, the compiler and the service's fused1 route.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as numpy arrays; the reference's Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it. Tolerances (x max|want|): f32 2e-4 on every
point; bf16 5e-2, f16 and bs16 the card's bar for the form (``FORM_TOL``,
chip_smoke.py): past one block a sum runs over up to 128 terms and a line
over 8192 points or more, and the order of the f32 sums (torch's einsum
against XLA's dot) puts some intermediates on the other side of a 16-bit
rounding (tests/test_torch_long_forms.py), and bf16's 8 bits make one
flipped rounding ~4e-3 of a point that a chain of three segments feeds
onward. Non-finite points must coincide. The CUDA kernel is held against
these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py (phase 21).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.tuning import cost as jcost

import repro_torch.core.sar as P
from repro_torch.core.sar.geometry import test_scene as tscene
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops
from repro_torch import tuning as tt
from repro_torch.service import BatchKey, LocalBackend
from repro_torch.tuning import cost

TOL = {"f32": 2e-4, "bf16": 5e-2, "f16": 2e-3, "bs16": 2e-3}

# (batch, na, nr, batch_block, range split)
SHAPES = {
    "2x8192": (1, 2, 8192, None, None),
    "8192x2": (1, 8192, 2, None, None),
    "1x16384": (1, 1, 16384, None, None),
    "128sq_8.4.4": (1, 128, 128, None, (8, 4, 4)),
    "4x64x64_bb2": (4, 64, 64, 2, None),
    "2x2x8192": (2, 2, 8192, None, None),
}
# fused1's chain and one with one-direction segments: every filter mode
# across them
CHAINS = (((0, True, False, "none"), (1, True, True, "shared_outer"),
           (0, False, True, "outer")),
          ((1, True, False, "outer"), (0, True, True, "full"),
           (1, False, True, "none")))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def chain_for(chain, na, nr, fft_impl):
    """``chain``; on the Stockham route, which transforms no 1-point line
    in either package, a 1-point axis only filtered."""
    if fft_impl != "stockham":
        return chain
    return tuple((a, False, False, m if m != "none" else "full")
                 if (nr if a == 1 else na) == 1 else (a, f, i, m)
                 for a, f, i, m in chain)


def payload(rng, segments, na, nr, rank=2):
    """Each segment's filter operands in scene coordinates."""
    args = []
    for axis, _fwd, _inv, mode in segments:
        n, lines = (nr, na) if axis == 1 else (na, nr)
        if mode in ("shared", "shared_outer"):
            args += [rand(rng, n), rand(rng, n)]
        if mode == "full":
            args += [rand(rng, na, nr), rand(rng, na, nr)]
        if mode in ("outer", "shared_outer"):
            args += [0.1 * rand(rng, lines, rank), rand(rng, n, rank)]
    return args


def assert_close_finite(got, want, tol):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    scale = max(float(np.abs(w[np.isfinite(w)]).max()) for w in want)
    for g, w in zip(got, want):
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], atol=tol * scale, rtol=0)


def both(name, chain, fft_impl, precision, seed=0):
    """(port's plain, reference's interpret-mode) images of one case."""
    batch, na, nr, bb, split = SHAPES[name]
    segs = chain_for(chain, na, nr, fft_impl)
    rng = np.random.default_rng(seed)
    x = [rand(rng, batch, na, nr) for _ in range(2)]
    args = payload(rng, segs, na, nr)
    kw = dict(segments=segs, residency="vmem", batch_block=bb,
              fft_impl=fft_impl, precision=precision)
    if split:
        kw.update(zip(("n1", "n2", "n3"), split))
    want = jops.mega_spectral_op(*(jnp.asarray(a) for a in x),
                                 *(jnp.asarray(a) for a in args),
                                 interpret=True, **kw)
    got = tops.mega_spectral_op(*(torch.from_numpy(a) for a in x),
                                *(torch.from_numpy(a) for a in args), **kw)
    return got, want


# ---------------------------------------------------------------------------
# The plain version against the live reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("chain", [0, 1])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_resident_long_matches_reference_f32(name, chain, fft_impl):
    got, want = both(name, CHAINS[chain], fft_impl, "f32", seed=chain)
    assert_close_finite(got, want, TOL["f32"])


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
@pytest.mark.parametrize("name", ["2x8192", "8192x2", "128sq_8.4.4",
                                  "4x64x64_bb2"])
def test_plain_resident_long_matches_reference_forms(name, precision,
                                                     fft_impl):
    got, want = both(name, CHAINS[0], fft_impl, precision, seed=3)
    assert_close_finite(got, want, TOL[precision])


def test_batch_block_leaves_the_plain_image_unchanged():
    """batch_block only groups scenes into blocks: bb = 2 is bb = 1 bit
    for bit (what the card's check of Bb > 1 holds the kernel to)."""
    rng = np.random.default_rng(9)
    x = [torch.from_numpy(rand(rng, 2, 1, 8192)) for _ in range(2)]
    segs = CHAINS[1]
    args = [torch.from_numpy(a) for a in payload(rng, segs, 1, 8192)]
    kw = dict(segments=segs, residency="vmem")
    one = tops.mega_spectral_op(*x, *args, **kw)
    two = tops.mega_spectral_op(*x, *args, batch_block=2, **kw)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# ---------------------------------------------------------------------------
# The residency cut, the kernels' check
# ---------------------------------------------------------------------------

# Every power-of-two scene up to 16384 a side: the cut agrees with the
# reference's wherever the slab fits one block; past it, the scenes the
# reference keeps in its 16 MiB VMEM budget and the card's 227 KiB block
# does not are listed (``_reference_only``).
_POW2 = [2 ** k for k in range(15)]


def _reference_only(batch_block):
    return sorted(
        (na, nr) for na in _POW2 for nr in _POW2
        if na * nr * batch_block > tops.RESIDENT_MAX_POINTS
        and jcost.mega_residency(na, nr, batch_block) == "vmem")


@pytest.mark.parametrize("batch_block", [1, 2])
def test_residency_cut_is_the_references_where_the_slab_fits(batch_block):
    fits = [(na, nr) for na in _POW2 for nr in _POW2
            if na * nr * batch_block <= tops.RESIDENT_MAX_POINTS]
    assert len(fits) == (120 if batch_block == 1 else 105)
    for na, nr in fits:
        assert tops.mega_residency(na, nr, batch_block) == "vmem"
        assert tops.mega_residency(na, nr, batch_block) == \
            jcost.mega_residency(na, nr, batch_block), (na, nr)
        assert cost.mega_residency(na, nr, batch_block) == "vmem"
    # past one block: staged on the card; the reference keeps in its
    # budget every slab of 2^15 to 2^19 points a block (3 slabs of 8 B a
    # point and the DFT constants under 16 MiB): 60 scenes at
    # batch_block 1, 65 at 2
    only = _reference_only(batch_block)
    assert only == sorted(
        (na, nr) for na in _POW2 for nr in _POW2
        if 2 ** 15 <= na * nr * batch_block <= 2 ** 19)
    assert len(only) == (60 if batch_block == 1 else 65)
    assert all(tops.mega_residency(na, nr, batch_block) == "staged"
               for na, nr in only)


@pytest.mark.parametrize("precision,karatsuba",
                         [("f32", False), ("bf16", False), ("f16", False),
                          ("bs16", False), ("bs16", True), ("f32", True)])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_check_takes_resident_long_chains_at_every_form(fft_impl, precision,
                                                        karatsuba):
    for name, (batch, na, nr, bb, split) in SHAPES.items():
        for chain in CHAINS:
            segs = tuple(tfft.SegmentSpec(axis=a, fwd=f, inv=i,
                                          filter_mode=m)
                         for a, f, i, m in chain_for(chain, na, nr,
                                                     fft_impl))
            kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
            spec = tfft.MegaSpec(na, nr, segs, residency="vmem",
                                 batch_block=bb, fft_impl=fft_impl,
                                 precision=precision, karatsuba=karatsuba,
                                 **kw)
            tops.check_mega_kernel(spec)
            tfft.check_mega(spec, batch)
    # the fit check stays: 256^2 and two 2 x 8192 scenes a block raise
    segs = tuple(tfft.SegmentSpec(axis=a, fwd=f, inv=i, filter_mode=m)
                 for a, f, i, m in CHAINS[0])
    for na, nr, bb in ((256, 256, 1), (2, 8192, 2)):
        with pytest.raises(ValueError, match="does not fit one block"):
            tops.check_mega_kernel(tfft.MegaSpec(
                na, nr, segs, residency="vmem", batch_block=bb,
                fft_impl=fft_impl, precision=precision))


# ---------------------------------------------------------------------------
# The compiler and the service
# ---------------------------------------------------------------------------

def long_cfg():
    return dataclasses.replace(tscene(128), na=2, nr=8192)


def long_raw(seed=6):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(2, 8192, generator=g),
                         torch.randn(2, 8192, generator=g))


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_fused1_on_2x8192_compiles_resident(fft_impl):
    """No residency pinned: fused1 on a 2 x 8192 scene compiles to vmem;
    its image is fused3's and a pinned staged fused1's bit for bit."""
    cfg, raw = long_cfg(), long_raw()
    kw = dict(device="cpu", fft_impl=fft_impl)
    one = P.build_pipeline(cfg, "fused1", **kw)
    assert one.dispatches == 1
    assert one.steps[0].kernel_kw["residency"] == "vmem"
    got = one.run(raw)
    assert torch.equal(got, P.build_pipeline(cfg, "fused3", **kw).run(raw))
    staged = P.build_pipeline(cfg, "fused1", residency="staged", **kw)
    assert staged.steps[0].kernel_kw["residency"] == "staged"
    assert torch.equal(got, staged.run(raw))


@pytest.mark.parametrize("precision", [None, "bs16"])
def test_local_backend_serves_2x8192_by_its_fused1_twin(precision):
    """The service's local backend routes a 2 x 8192 fused3 request to
    its fused1 twin (one mega_resident launch on the card), and the
    served image is the requested variant's bit for bit."""
    cfg = long_cfg()
    backend = LocalBackend(device="cpu", sweep=((None, None),))
    key = BatchKey(cfg, "fused3", precision, False)
    assert backend._route_variant(key) == "fused1"
    raw = long_raw(7).numpy()[None]
    out = backend.execute(key, raw)
    kw = {} if precision is None else {"precision": precision}
    want = P.build_pipeline(cfg, "fused3", device="cpu", **kw).run(
        torch.from_numpy(raw[0])).numpy()
    np.testing.assert_array_equal(out[0], want)
    off = LocalBackend(device="cpu", sweep=((None, None),), fused1="off")
    assert off._route_variant(key) == "fused3"


def test_tuner_prices_both_residencies_of_a_long_fused1():
    """The schedule search's fused1 lanes at 2 x 8192 take both
    residencies (the kernels' check admits the resident one now), and
    the resident lane prices its long passes over shared memory."""
    segs = (tt.SegmentShape(0, fwd=True),
            tt.SegmentShape(1, fwd=True, inv=True, filtered=True),
            tt.SegmentShape(0, inv=True, filtered=True))
    problem = tt.ScheduleProblem.mega_2d(2, 8192, segs)
    for res in ("vmem", "staged"):
        ranked = tt.schedule_frontier(problem, k=2, residencies=(res,))
        assert ranked and all(s.residency == res for s in ranked)
        assert all(cost.schedule_seconds(s, problem) > 0 for s in ranked)
    terms = cost._dispatch_terms(
        n=8192, lines=2, batch=1, factors=(128, 64), karatsuba=False,
        precision="f32", transforms=2, filtered=True, block=None, tile=2,
        slab_io=False, resident=True)
    staged = cost._dispatch_terms(
        n=8192, lines=2, batch=1, factors=(128, 64), karatsuba=False,
        precision="f32", transforms=2, filtered=True, block=None, tile=2,
        slab_io=False)
    assert terms["smem_bytes"] > 0 and staged["smem_bytes"] == 0
    # a rows segment of one digit runs whole-line tiles staged too: one
    # read and write of its lines, the resident slab's device bytes; a
    # column segment's passes go through device memory staged
    assert terms["bytes_moved"] == staged["bytes_moved"]
    col = dict(n=8192, lines=2, batch=1, factors=(128, 64),
               karatsuba=False, precision="f32", transforms=1,
               filtered=True, block=None, tile=2, slab_io=False, axis=0)
    assert cost._dispatch_terms(resident=True, **col)["bytes_moved"] < \
        cost._dispatch_terms(**col)["bytes_moved"]
