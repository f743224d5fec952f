"""Lines longer than one block of the CUDA kernels (N > 4096) and the
matmul route's three-factor splits: the port's plain versions against the
JAX reference, the pass geometry of the device-memory four-step
(``ops.long_geometry``, ``csrc/long_lines.cuh``), what the kernels' checks
take and refuse, and a reduced long-line scene focused by both packages.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as numpy arrays; the reference's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them. Tolerance: 2e-4 x max|want| (the
reference's own at f32; its 32768-point test holds jnp.fft's complex64 to
1e-3, and two f32 four-steps agree far inside 2e-4 there too). The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py (phase 19).
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
from repro.kernels import ops as jops

import repro_torch.core.sar as P
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops

F32_TOL = 2e-4


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_close(got, want, tol=F32_TOL):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0)


def spectral_case(seed, n, axis, mode, lines=3, batch=2):
    rng = np.random.default_rng(seed)
    scene = (lines, n) if axis == 1 else (n, lines)
    x = (rand(rng, batch, *scene), rand(rng, batch, *scene))
    filt = {}
    if mode == "full":
        filt.update(hr=rand(rng, *scene), hi=rand(rng, *scene))
    if mode == "outer":
        filt.update(u=0.1 * rand(rng, lines, 2), v=rand(rng, n, 2))
    return x, filt


def both(x, filt, **kw):
    want = jops.spectral_op(*(jnp.asarray(a) for a in x),
                            **{k: jnp.asarray(v) for k, v in filt.items()},
                            **kw)
    got = tops.spectral_op(*(torch.from_numpy(a) for a in x),
                           **{k: torch.from_numpy(v)
                              for k, v in filt.items()}, **kw)
    return got, want


# ---------------------------------------------------------------------------
# The pass geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "n,fft_impl,split,digits,stages,tail,tiles,tail_tile,passes", [
        (8192, "matmul", None, (128,), ((16, 8),), (8, 8), (64,), 256,
         (1, 1, 1, 1)),
        (16384, "matmul", None, (128,), ((16, 8),), (16, 8), (128,), 128,
         (1, 1, 1, 1)),
        (32768, "matmul", None, (32,), ((8, 4),), (32, 32), (512,), 16,
         (3, 2, 2, 1)),
        (2 ** 21, "matmul", None, (128, 128), ((16, 8), (16, 8)), (16, 8),
         (128, 128), 128, (5, 3, 3, 1)),
        (512, "matmul", (8, 8, 8), (8,), ((8, 1),), (8, 8), (64,), 256,
         (3, 2, 2, 1)),
        (512, "matmul", (16, 8, 4), (16,), ((16, 1),), (8, 4), (32,), 512,
         (3, 2, 2, 1)),
        (4096, "matmul", (16, 16, 16), (16,), ((16, 1),), (16, 16), (256,),
         64, (1, 1, 1, 1)),
        (8192, "stockham", None, (2,), (), (4096,), (4096,), 2,
         (1, 1, 1, 1)),
        (2 ** 21, "stockham", None, (512,), (), (4096,), (16,), 2,
         (3, 2, 2, 1)),
    ])
def test_long_geometry_lengths_tiles_and_passes(n, fft_impl, split, digits,
                                                stages, tail, tiles,
                                                tail_tile, passes):
    """The leading factor(s) run as device-memory passes (the next one too
    where the last two multiply past 4096), the rest in a tile; on the
    matmul route a factor past 16 in two tensor-core stages (a one-factor
    tail too); a pass a digit and direction plus the tail over device
    memory (``tile_passes``), all of them in one whole-line pass on the
    rows layout with one digit and 4096 <= N <= 16384; every tile fits
    one block."""
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    spec = tfft.SpectralSpec(n=n, fwd=True, inv=True, filter_mode="shared",
                             fft_impl=fft_impl, **kw)
    g = tops.long_geometry(spec)
    assert (g.digits, g.digit_splits, g.tail, g.digit_tiles, g.tail_tile) \
        == (digits, stages, tail, tiles, tail_tile)
    assert all(max(sp) <= tops.LONG_STAGE_MAX for sp in g.digit_splits)
    assert np.prod(g.digits) * g.tail_n == n
    d = len(digits)
    assert (g.passes(True, True), g.passes(True, False),
            g.passes(False, True), g.passes(False, False)) == passes
    assert (g.tile_passes(True, True), g.tile_passes(True, False),
            g.tile_passes(False, True), g.tile_passes(False, False)) == \
        (2 * d + 1, d + 1, d + 1, 1)
    assert g.whole_line == (passes[0] == 1)
    assert 0 < g.smem_bytes() <= tops.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("n,axis,fft_impl,split,precision,fits", [
    (8192, 0, "matmul", None, "f32", (True, True)),
    (16384, 0, "matmul", None, "bs16", (True, True)),
    (32768, 1, "matmul", None, "f32", (True, True)),
    (2 ** 21, 0, "matmul", None, "f32", (True, True, True)),
    (4096, 0, "matmul", (16, 16, 16), "f32", (True, True)),
    (8192, 0, "stockham", None, "f32", (True, False)),
    (32768, 1, "stockham", None, "bs16", (True, True)),
])
def test_ring_slots_fit_beside_each_tile(monkeypatch, n, axis, fft_impl,
                                         split, precision, fits):
    """With ``LONG_RING`` each tile pass's tiles are sized so that the
    ring's two slots (8 bytes a point each) fit beside the tile and its
    DFT matrices in one block's opt-in; the Stockham route's column tail
    (4 lines of 4096 points: 131,072 B, its slots 262,144 B more) takes
    none. Without it the tiles are today's, at least as large, and the
    shared memory has no slots. ``fits``: each digit's pass, then the
    tail's."""
    monkeypatch.setattr(tops, "LONG_RING", True)
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    spec = tfft.SpectralSpec(n=n, fwd=True, inv=True, filter_mode="full",
                             axis=axis, fft_impl=fft_impl,
                             precision=precision, **kw)
    g = tops.long_geometry(spec)
    assert g.ring and not g.whole_line
    tiles = [(f * c, f * (c + tops._digit_pad(sp[1], fft_impl)),
              tops.dft_smem_bytes(*(sp if sp[1] > 1 else (f, f))))
             for f, c, sp in zip(g.digits, g.digit_tiles,
                                 g.digit_splits or [(f, 1)
                                                    for f in g.digits])]
    tail = g.tail if len(g.tail) == 2 else g.tail * 2
    tiles.append((g.tail_n * g.tail_tile, g.tail_n * g.tail_tile,
                  tops.dft_smem_bytes(*tail)))
    got = []
    for pts, slots, mats in tiles:
        before = 8 * (-(-slots // 16) * 16 if fft_impl == "stockham"
                      else slots) + (0 if fft_impl == "stockham" else mats)
        extra = tops.ring_bytes(True, before, pts)
        got.append(extra > 0)
        assert before + extra <= g.smem_bytes() <= tops.SMEM_OPTIN_BYTES
        if extra:
            assert extra >= tops.RING_SLOTS * 8 * pts
    assert tuple(got) == fits
    monkeypatch.setattr(tops, "LONG_RING", False)
    s = tops.long_geometry(spec)
    assert not s.ring
    assert all(a >= b for a, b in zip(s.digit_tiles, g.digit_tiles))
    assert s.tail_tile >= g.tail_tile
    assert s.smem_bytes() <= tops.SMEM_OPTIN_BYTES


_HEADER = (__import__("pathlib").Path(tops.__file__).parent / "csrc"
           / "long_lines.cuh")


@pytest.mark.parametrize("name,value", [
    ("kLineMinN", tops.LINE_MIN_N), ("kLineMaxN", tops.LINE_MAX_N),
    ("kSmemOptin", tops.SMEM_OPTIN_BYTES),
    ("kTileVecPoints", tops.TILE_VEC_POINTS),
    ("kRingSlots", tops.RING_SLOTS),
    ("kDigitFields", tops._DIGIT_FIELDS),
    ("kSegFields", tops._SEG_FIELDS),
])
def test_host_constants_are_the_kernels(name, value):
    """The host's copies of csrc/long_lines.cuh's constants: which ops
    take the whole-line form, the opt-in, the ring's sizes and the
    segment record's length (its fields before the digits plus
    kMaxDigits digits)."""
    import re
    text = _HEADER.read_text()
    m = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", text)
    assert m, name
    expr = m.group(1)
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kMaxDigits|kDigitFields) = (\d+);", text)}
    for k, v in consts.items():
        expr = expr.replace(k, str(v))
    assert eval(expr) == value


@pytest.mark.parametrize("n,fft_impl", [(32768, "matmul"),
                                        (2 ** 21, "matmul"),
                                        (8192, "stockham")])
def test_long_segment_record_layout(n, fft_impl):
    """The int64 record the kernels unpack (csrc/long_lines.cuh
    unpack_segment): its length, the Karatsuba field where the megakernel
    wrapper picks its library by it, the long fields' digits, factors,
    tiles and ring, and a scratch slab for one direction alone."""
    spec = tfft.SpectralSpec(n=n, fwd=True, inv=False, filter_mode="none",
                             fft_impl=fft_impl)
    g = tops.long_geometry(spec)
    pair = (torch.zeros(1), torch.zeros(1))
    head, fields, _ = tops._long_fields(spec, g, torch.device("cpu"), pair)
    filt = (None,) * 4 + (1,) + (0,) * 6
    for kara in (0, 1):
        rec = tops._record(0, True, False, "none", filt, head, kara, fields)
        assert len(rec) == tops._SEG_FIELDS == 27 + tops._LONG_FIELDS
        assert rec[tops._KARA_FIELD] == kara
    assert rec[5] == g.tail_n and rec[8] == g.tail_tile
    assert rec[27:31] == [1, len(g.digits), g.tail_tile, int(g.ring)]
    assert rec[31] == pair[0].data_ptr() and rec[32] == pair[1].data_ptr()
    for i, (f, c) in enumerate(zip(g.digits, g.digit_tiles)):
        d = rec[33 + tops._DIGIT_FIELDS * i:][:tops._DIGIT_FIELDS]
        fb = g.digit_splits[i][1] if fft_impl == "matmul" else 0
        assert d[:3] == [f, c, fb] and d[-2] != 0    # the twiddle
        assert (d[9] != 0) == (fft_impl == "stockham")


@pytest.mark.parametrize("n,fft_impl,kw", [
    (4096, "matmul", {}), (4096, "stockham", {}), (2, "stockham", {}),
    (4096, "matmul", dict(n1=128, n2=32))])
def test_lines_of_one_block_keep_their_single_pass(n, fft_impl, kw):
    spec = tfft.SpectralSpec(n=n, fwd=True, inv=True, filter_mode="none",
                             fft_impl=fft_impl, **kw)
    assert tops.long_geometry(spec) is None
    filt = tfft.SpectralSpec(n=8192, fwd=False, inv=False,
                             filter_mode="full", fft_impl=fft_impl)
    assert tops.long_geometry(filt).tail == ()    # one elementwise pass


@pytest.mark.parametrize("n,axis,fft_impl,split,precision,whole", [
    (8192, 1, "matmul", None, "f32", True),
    (16384, 1, "matmul", None, "f32", True),
    (8192, 1, "matmul", None, "bs16", True),
    (16384, 1, "matmul", None, "bf16", True),
    (8192, 1, "matmul", (32, 16, 16), "f32", True),
    (8192, 1, "stockham", None, "f32", True),
    (16384, 1, "stockham", None, "bs16", True),
    (4096, 1, "matmul", (16, 16, 16), "f32", True),
    (512, 1, "matmul", (8, 8, 8), "bs16", False),
    (512, 1, "matmul", (16, 8, 4), "f32", False),
    (8192, 0, "matmul", None, "f32", False),
    (16384, 0, "stockham", None, "f32", False),
    (4096, 0, "matmul", (16, 16, 16), "f32", False),
    (32768, 1, "matmul", None, "f32", False),
    (32768, 1, "stockham", None, "f32", False),
    (2 ** 21, 1, "matmul", None, "f32", False),
])
def test_whole_line_form_takes_rows_of_one_digit(n, axis, fft_impl, split,
                                                 precision, whole):
    """The rows layout with one device-memory digit and 4096 <= N <=
    16384 runs every pass in one whole-line tile: one device-memory pass
    whatever the direction, no scratch slab (a one-direction op's moves
    and the natural schedule's stay in the tile), the line's bytes and the
    DFT matrices that fit beside it; columns, shorter lines, lines past
    16384 and two digits keep the passes (a one-direction op its
    scratch)."""
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    for fwd, inv in ((True, True), (True, False), (False, True)):
        spec = tfft.SpectralSpec(n=n, fwd=fwd, inv=inv, filter_mode="full",
                                 axis=axis, fft_impl=fft_impl,
                                 precision=precision, **kw)
        g = tops.long_geometry(spec)
        assert g.whole_line == whole
        passes = g.passes(fwd, inv)
        assert passes == (1 if whole else g.tile_passes(fwd, inv)) and \
            (whole or passes > 1)
        needs = tops._needs_scratch(spec, g)
        assert needs == (not whole and (fwd != inv or g.natural))
        if whole:
            line = 8 * n
            assert line <= g.smem_bytes() <= tops.SMEM_OPTIN_BYTES
            if fft_impl == "stockham":
                assert g.smem_bytes() == line
    filt = tfft.SpectralSpec(n=n, fwd=False, inv=False, filter_mode="full",
                             axis=axis, fft_impl=fft_impl)
    if n > 4096:   # filter-only past one block: one elementwise pass
        g = tops.long_geometry(filt)
        assert not g.whole_line and g.passes(False, False) == 1
        assert not tops._needs_scratch(filt, g)


@pytest.mark.parametrize("n,split,whole", [(8192, None, True),
                                           (16384, None, True),
                                           ((4096), (16, 16, 16), True),
                                           (32768, None, False),
                                           (2 ** 21, None, False)])
def test_cost_prices_a_whole_line_op_as_one_slab_read_and_write(n, split,
                                                               whole):
    """tuning/cost.py's bytes term follows ``LongGeometry.passes``: a
    whole-line op reads and writes its slab once (its DFT constants
    besides), an op of device-memory passes once a pass; a resident
    megakernel's segment prices the passes' sweeps over shared memory
    (``tile_passes``) and no device memory."""
    from repro_torch.tuning import cost
    fs = split or tfft.default_factorization(n)
    lines, slab = 64, 2 * 2 * 4 * n * 64
    geom = cost._long(n, fs)
    assert geom.whole_line == whole
    for transforms in (1, 2):
        t = cost._dispatch_terms(n=n, lines=lines, batch=1, factors=fs,
                                 karatsuba=False, precision="f32",
                                 transforms=transforms, filtered=False,
                                 block=None, tile=lines)
        extra = t["bytes_moved"] - slab - cost._const_bytes(fs)
        passes = geom.passes(transforms == 2, True)
        assert extra == (passes - 1) * slab
        assert (extra == 0) == whole
        r = cost._dispatch_terms(n=n, lines=lines, batch=1, factors=fs,
                                 karatsuba=False, precision="f32",
                                 transforms=transforms, filtered=False,
                                 block=None, tile=lines, slab_io=False,
                                 resident=True)
        assert r["smem_bytes"] == 2 * geom.tile_passes(
            transforms == 2, True) * slab


# ---------------------------------------------------------------------------
# What the kernels take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,fft_impl,kw,split", [
    (8192, "matmul", {}, (128, 64)),
    (32768, "matmul", {}, (32, 32, 32)),
    (2 ** 21, "matmul", {}, (128, 128, 128)),
    (512, "matmul", dict(n1=8, n2=8, n3=8), (8, 8, 8)),
    (512, "matmul", dict(n1=16, n2=8, n3=4), (16, 8, 4)),
    (8192, "matmul", dict(n1=32, n2=16, n3=16), (32, 16, 16)),
    (8192, "stockham", {}, (8192, 1)),
    (2 ** 21, "stockham", {}, (2 ** 21, 1)),
])
def test_kernel_checks_take_long_lines_at_every_form(n, fft_impl, kw,
                                                     split):
    """Every precision and Karatsuba past one block: the split the
    kernels take, the 16-bit forms on the matmul route one stage a factor
    and the natural schedule (2D + 2 passes fwd + inv); n = 2^22 is taken
    by no route."""
    spec = tfft.SpectralSpec(n=n, fwd=True, inv=False, filter_mode="none",
                             fft_impl=fft_impl, **kw)
    assert tops.check_kernel_spec(spec) == split
    for form in (dict(precision="bf16"), dict(precision="f16"),
                 dict(precision="bs16"), dict(karatsuba=True),
                 dict(precision="bs16", karatsuba=True)):
        narrow = dataclasses.replace(spec, **form)
        assert tops.check_kernel_spec(narrow) == split
        g = tops.long_geometry(narrow)
        sixteen = fft_impl == "matmul" and narrow.precision != "f32"
        assert g.natural == sixteen
        if sixteen:
            assert all(sp == (f, 1)
                       for f, sp in zip(g.digits, g.digit_splits))
            assert g.tile_passes(True, True) == 2 * len(g.digits) + 2
            assert g.passes(True, True) == (
                1 if g.whole_line else 2 * len(g.digits) + 2)
            assert 0 < g.smem_bytes() <= tops.SMEM_OPTIN_BYTES
        else:
            assert g == tops.long_geometry(spec)
    with pytest.raises(ValueError):
        tops.check_kernel_spec(dataclasses.replace(spec, n=2 ** 22, n1=None,
                                                   n2=None, n3=None))


def test_mega_check_takes_long_segments_staged_and_resident_at_every_form():
    segs = (tfft.SegmentSpec(axis=0, fwd=True),
            tfft.SegmentSpec(axis=1, fwd=True, inv=True,
                             filter_mode="shared"),
            tfft.SegmentSpec(axis=0, inv=True, filter_mode="full"))
    for impl in ("matmul", "stockham"):
        for prec in ("f32", "bf16", "f16", "bs16"):
            tops.check_mega_kernel(tfft.MegaSpec(8192, 16384, segs,
                                                 residency="staged",
                                                 fft_impl=impl,
                                                 precision=prec))
    tops.check_mega_kernel(tfft.MegaSpec(8192, 64, segs, residency="staged",
                                         precision="bs16", karatsuba=True))
    filt = (tfft.SegmentSpec(axis=1, filter_mode="full"),)
    tops.check_mega_kernel(tfft.MegaSpec(8, 8192, filt, residency="staged",
                                         precision="bs16"))
    # mega_resident runs the long passes on its slab
    tops.check_mega_kernel(tfft.MegaSpec(
        8, 512, segs[1:2], residency="vmem", n1=8, n2=8, n3=8))
    tops.check_mega_kernel(tfft.MegaSpec(
        2, 8192, segs[1:2], residency="vmem", precision="bs16"))
    with pytest.raises(ValueError, match="does not fit one block"):
        tops.check_mega_kernel(tfft.MegaSpec(
            4, 8192, segs[1:2], residency="vmem", precision="bs16"))


# ---------------------------------------------------------------------------
# The plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("mode", ["full", "outer"])
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("n", [8192, 32768])
def test_plain_long_lines_match_reference(n, axis, mode, fft_impl):
    """fwd * H * inv past one block, on the kernels' decomposition (the
    Stockham route's own four-step; the matmul route's recursion), against
    the reference's interpret-mode kernel."""
    x, filt = spectral_case(n + axis, n, axis, mode)
    got, want = both(x, filt, axis=axis, fwd=True, inv=True,
                     filter_mode=mode, fft_impl=fft_impl)
    assert_close(got, want)


@pytest.mark.parametrize("fwd,inv", [(True, False), (False, True)])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_plain_long_forward_or_inverse_alone_match_reference(fft_impl, fwd,
                                                             inv):
    x, filt = spectral_case(7, 8192, 0, "full")
    got, want = both(x, filt, axis=0, fwd=fwd, inv=inv, filter_mode="full",
                     fft_impl=fft_impl)
    assert_close(got, want)


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("split", [(8, 8, 8), (16, 8, 4), (32, 16, 16)])
def test_plain_explicit_three_factor_splits_match_reference(split, axis):
    n = int(np.prod(split))
    for mode in ("full", "outer"):
        x, filt = spectral_case(n + axis, n, axis, mode, lines=5)
        got, want = both(x, filt, axis=axis, fwd=True, inv=True,
                         filter_mode=mode, n1=split[0], n2=split[1],
                         n3=split[2])
        assert_close(got, want)


@pytest.mark.parametrize("n", [8192, 32768, 2 ** 18])
def test_stockham_long_plain_is_an_fft(n):
    """``stockham_fft`` past one block: the forward against complex128
    numpy, the inverse (its passes in the opposite order on a conjugated
    input) a round trip."""
    rng = np.random.default_rng(n)
    x = rand(rng, 2, n) + 1j * rand(rng, 2, n)
    xr, xi = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    yr, yi = tfft.stockham_fft(xr, xi, 1)
    want = np.fft.fft(x.astype(np.complex128), axis=1)
    got = yr.numpy() + 1j * yi.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    br, bi = tfft.stockham_fft(yr, -yi, 1, inverse=True)
    back = (br.numpy() - 1j * bi.numpy()) / n
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max()
    cr, ci = tfft.stockham_fft(xr.T.contiguous(), xi.T.contiguous(), 0)
    assert torch.equal(cr.T, yr) and torch.equal(ci.T, yi)


def test_four_step_twiddle_is_the_dft_constants_twiddle():
    """One float64 table rounded once: the matmul route's inter-stage
    twiddle and the long passes' are the same bits."""
    consts = tfft.dft_constants(32, 16, 16)
    tw = tfft.four_step_twiddle(32, 256)
    assert np.array_equal(consts[6], tw[0]) and np.array_equal(
        consts[7], tw[1])
    k, j = np.meshgrid(np.arange(32), np.arange(256), indexing="ij")
    want = np.exp(-2j * np.pi * (k * j) / 8192)
    assert np.abs(tw[0] - want.real).max() <= 2 ** -24
    assert np.abs(tw[1] - want.imag).max() <= 2 ** -24


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_mega_plain_long_segment_matches_reference(fft_impl):
    """A staged chain whose azimuth segments transform 8192 points."""
    rng = np.random.default_rng(3)
    na, nr = 8192, 8
    segments = ((0, True, False, "none"), (1, True, True, "shared"),
                (0, False, True, "full"))
    x = [rand(rng, 1, na, nr) for _ in range(2)]
    args = [rand(rng, nr), rand(rng, nr), rand(rng, na, nr),
            rand(rng, na, nr)]
    kw = dict(segments=segments, residency="staged", fft_impl=fft_impl)
    want = jops.mega_spectral_op(*(jnp.asarray(a) for a in x),
                                 *(jnp.asarray(a) for a in args), **kw)
    got = tops.mega_spectral_op(*(torch.from_numpy(a) for a in x),
                                *(torch.from_numpy(a) for a in args), **kw)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# A reduced long-line scene through both packages
# ---------------------------------------------------------------------------

_scene = {}


def long_scene():
    """The reference's 64-line test scene with 8192 range samples."""
    if not _scene:
        cfg = dataclasses.replace(make_jscene(64), nr=8192)
        targets = jtargets(cfg)
        raw = np.array(jsimulate_cached(cfg, targets), np.complex64)
        _scene.update(cfg=cfg, targets=targets, raw=raw, want=np.asarray(
            jbuild(cfg, "fused3", tune="off").run(jnp.asarray(raw))))
    return _scene


@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
def test_reduced_long_scene_matches_live_reference(fft_impl):
    """fused3 on the CPU gives the live reference's peaks within 0.1 dB;
    fused1 equals it bit for bit."""
    sc = long_scene()
    cfg = P.scene_from_dict(dataclasses.asdict(sc["cfg"]))
    raw = torch.from_numpy(sc["raw"])
    got = P.build_pipeline(cfg, "fused3", device="cpu",
                           fft_impl=fft_impl).run(raw)
    cmp = jmetrics.compare_pipelines(got.numpy(), sc["want"], sc["cfg"],
                                     sc["targets"])
    assert max(cmp["snr_delta_db"]) <= 0.1, cmp["snr_delta_db"]
    assert [(r.row, r.col) for r in cmp["reports_a"]] == \
        [(r.row, r.col) for r in cmp["reports_b"]]
    one = P.build_pipeline(cfg, "fused1", device="cpu", fft_impl=fft_impl)
    assert one.steps[0].kernel_kw["residency"] == "staged"
    assert torch.equal(one.run(raw), got)
