"""The hand-written CUDA kernels (the spectral kernel and the two
megakernels, each on both FFT routes, and the tiled transpose) against
their plain PyTorch versions, on the card. Imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test here needs a CUDA card (marker ``gpu``) and skips without one:
the CUDA kernels have no CPU mode. Tolerance 2e-4 x max|want|, the
reference's own (tests/test_kernels.py); a transpose is exact. Both FFT
routes are also held to torch.fft in complex128 at 1e-5 x max|want|,
which one TF32 pass (~3e-4) on the matmul route's tensor-core stages
would miss. The Stockham route's bf16 and f16 are its f32 passes, and its
bs16 codec is held bit for bit to the plain version on lines whose values
are subnormal, the one place where it changes a result.

The matmul route's other operand forms (bf16 and f16 on m16n8k16, bs16,
Karatsuba) round every operand where the plain version does, so they
differ from it only in the order of f32 accumulation, and where a
re-ordered sum lands on the other side of a 16-bit rounding at a later
stage, and a megakernel chains up to three segments of such roundings:
FORM_TOL holds them to 1e-2 x max|want| (bf16) and 2e-3 (f16, bs16), five
and twenty-five times inside the reference's bf16 bound of 5e-2; f32 with
Karatsuba keeps 2e-4 and the complex128 oracle's 1e-5.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import transpose as tr

TOL = 2e-4
ORACLE_TOL = 1e-5
FORM_TOL = {"f32": TOL, "bf16": 1e-2, "f16": 2e-3, "bs16": 2e-3}
# the matmul route's operand forms besides f32: (precision, karatsuba)
FORMS = [("f32", True), ("bf16", False), ("bf16", True), ("f16", False),
         ("f16", True), ("bs16", False), ("bs16", True)]
MODES = ["none", "shared", "full", "outer", "shared_outer"]
DIRS = [(True, False), (False, True), (True, True), (False, False)]


@pytest.fixture(autouse=True, scope="module")
def empty_tuning_cache(tmp_path_factory):
    """tune="cached" is the compile default: the compiles here read an
    empty tuning cache of this module's own, never the user's."""
    path = tmp_path_factory.mktemp("tuning") / "autotune_cache.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_case(device, seed, mode, axis, n, batch, lines, rank=2):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    scene = (lines, n) if axis == 1 else (n, lines)
    x = (rand(batch, *scene), rand(batch, *scene))
    filt = {}
    if mode in ("shared", "shared_outer"):
        filt.update(hr=rand(n), hi=rand(n))
    if mode == "full":
        filt.update(hr=rand(*scene), hi=rand(*scene))
    if mode in ("outer", "shared_outer"):
        filt.update(u=rand(lines, rank), v=rand(n, rank))
    return x, filt


def assert_close(got, want, tol=TOL):
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("fwd,inv", DIRS)
@pytest.mark.parametrize("n", [16, 128, 1024, 4096])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_matches_plain(cuda_device, mode, axis, n, fwd, inv):
    if mode == "none" and not (fwd or inv):
        pytest.skip("nothing to compute")
    x, filt = make_case(cuda_device, n, mode, axis, n, 2, lines=13)
    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1)
    before = ops.SPECTRAL_LAUNCHES
    got = ops.spectral_op(*x, **filt, **kw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    assert_close(got, ops.spectral_op_plain(*x, **filt, **kw))


def assert_oracle(got, z):
    """Split float32 ``got`` within ORACLE_TOL x max|z| of complex128 z."""
    err = max(float((got[0].double() - z.real).abs().max()),
              float((got[1].double() - z.imag).abs().max()))
    assert err <= ORACLE_TOL * float(z.abs().max()), err


def fft128(z, dim, fwd, inv):
    if fwd:
        z = torch.fft.fft(z, dim=dim)
    if inv:
        z = torch.fft.ifft(z, dim=dim)
    return z


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("fwd,inv", DIRS[:3])
@pytest.mark.parametrize("n", [16, 128, 1024, 4096])
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_matmul_route_matches_complex128(cuda_device, axis, n, fwd,
                                              inv, fft_impl):
    """Each FFT route against torch.fft in complex128 (the name predates
    the Stockham route's oracle)."""
    x, _ = make_case(cuda_device, n + 2, "none", axis, n, 2, lines=13)
    got = ops.spectral_op(*x, axis=axis, fwd=fwd, inv=inv, block=1,
                          fft_impl=fft_impl)
    z = torch.complex(x[0].double(), x[1].double())
    assert_oracle(got, fft128(z, -1 if axis == 1 else -2, fwd, inv))


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("residency,shape", [
    ("vmem", (128, 128)), ("staged", (128, 128)), ("vmem", (64, 128)),
    ("staged", (256, 512))])
def test_cuda_megakernels_match_complex128(cuda_device, residency, shape,
                                           fft_impl):
    segments = ((0, True, False, "none"), (1, True, True, "none"),
                (0, False, True, "none"))
    x, _ = make_mega_case(cuda_device, 3, segments, 2, *shape)
    got = ops.mega_spectral_op(*x, segments=segments, residency=residency,
                               fft_impl=fft_impl)
    z = torch.complex(x[0].double(), x[1].double())
    for axis, fwd, inv, _mode in segments:
        z = fft128(z, -1 if axis == 1 else -2, fwd, inv)
    assert_oracle(got, z)


@pytest.mark.gpu
def test_cuda_kernel_unbatched_and_padded(cuda_device):
    x, filt = make_case(cuda_device, 3, "outer", 0, 256, 1, lines=21)
    kw = dict(axis=0, fwd=True, inv=True, filter_mode="outer", block=8)
    got = ops.spectral_op(x[0][0], x[1][0], **filt, **kw)
    assert got[0].shape == (256, 21)
    assert_close(got, ops.spectral_op_plain(x[0][0], x[1][0], **filt, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("fwd,inv", DIRS)
@pytest.mark.parametrize("n", [2, 16, 32, 128, 256, 1024, 4096])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stockham_matches_plain(cuda_device, mode, axis, n, fwd, inv):
    """The Stockham route, bit for bit (its passes pair on registers, which
    changes which thread computes a point, never how): N = 2 and 16, 256,
    4096 turn a fwd+inv op around in registers; 32 ends on a lone radix-2
    pass, 128 on a radix-4/radix-2 pair, 1024 on a lone radix-4 pass."""
    if mode == "none" and not (fwd or inv):
        pytest.skip("nothing to compute")
    x, filt = make_case(cuda_device, n + 1, mode, axis, n, 2, lines=13)
    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
              fft_impl="stockham")
    before = ops.SPECTRAL_LAUNCHES
    got = ops.spectral_op(*x, **filt, **kw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    want = ops.spectral_op_plain(*x, **filt, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def subnormal_lines(x, axis):
    """Odd lines times 1e-40 (subnormal floats), beside unit-scale lines."""
    for t in x:
        if axis == 1:
            t[:, 1::2] *= 1e-40
        else:
            t[:, :, 1::2] *= 1e-40
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("fwd,inv", DIRS)
@pytest.mark.parametrize("n", [16, 128, 1024, 4096])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stockham_precisions_match_plain(cuda_device, mode, axis, n,
                                              fwd, inv):
    """bs16 on the Stockham route: each line's exponent from its loaded
    points, scaled out before the first butterflies and back in at the
    store. On lines whose values are subnormal it changes the result, and
    there the kernel equals its bs16 plain version bit for bit and differs
    from the f32 kernel; bf16 and f16 are the f32 passes."""
    if mode == "none" and not (fwd or inv):
        pytest.skip("nothing to compute")
    x, filt = make_case(cuda_device, n + 3, mode, axis, n, 2, lines=13)
    x = subnormal_lines(x, axis)
    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
              fft_impl="stockham")
    f32 = ops.spectral_op(*x, **filt, **kw)
    before = ops.SPECTRAL_LAUNCHES
    got = ops.spectral_op(*x, **filt, precision="bs16", **kw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    want = ops.spectral_op_plain(*x, **filt, precision="bs16", **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if not (mode == "none" and fwd and inv):
        # a round trip with nothing between can land on the input's
        # subnormal grid either way: its 1/N shrinks the f32 path's error
        # below that grid's step
        assert not all(torch.equal(g, w) for g, w in zip(got, f32))
    normal = (slice(None), slice(0, None, 2)) if axis == 1 else \
        (slice(None), slice(None), slice(0, None, 2))
    assert all(torch.equal(g[normal], w[normal]) for g, w in zip(got, f32))
    for precision in ("bf16", "f16"):
        narrow = ops.spectral_op(*x, **filt, precision=precision, **kw)
        assert all(torch.equal(g, w) for g, w in zip(narrow, f32))


@pytest.mark.gpu
def test_cuda_kernel_refuses_and_never_falls_back(cuda_device):
    x, _ = make_case(cuda_device, 5, "none", 1, 64, 1, lines=4)
    before = ops.SPECTRAL_LAUNCHES
    with pytest.raises(ValueError, match="ROADMAP"):
        ops.fft_rows(*x, fft_impl="bluestein")
    big = make_case(cuda_device, 5, "none", 1, 8192, 1, lines=2)[0]
    assert ops.SPECTRAL_LAUNCHES == before
    # N = 8192 at f32, refused before, now launches on both routes, and so
    # do bf16, bs16 and Karatsuba there (the Stockham route's bf16 is its
    # f32 passes)
    for i, kw in enumerate((dict(), dict(fft_impl="stockham"),
                            dict(precision="bf16"), dict(precision="bs16"),
                            dict(karatsuba=True),
                            dict(fft_impl="stockham", precision="bf16"))):
        got = ops.fft_rows(*big, **kw)
        torch.cuda.synchronize()
        assert ops.SPECTRAL_LAUNCHES == before + i + 1
        assert_close(got, ops.spectral_op_plain(*big, fwd=True, inv=False,
                                                **kw),
                     FORM_TOL[kw.get("precision", "f32")])
    before = ops.SPECTRAL_LAUNCHES
    # the Stockham route and the matmul route's bf16, bs16 and Karatsuba,
    # refused before, now launch
    kws = (dict(fft_impl="stockham"), dict(precision="bf16"),
           dict(precision="bs16"), dict(karatsuba=True))
    for i, kw in enumerate(kws):
        got = ops.fft_rows(*x, **kw)
        torch.cuda.synchronize()
        assert ops.SPECTRAL_LAUNCHES == before + i + 1
        assert_close(got, ops.spectral_op_plain(*x, fwd=True, inv=False,
                                                **kw),
                     FORM_TOL[kw.get("precision", "f32")])


# ---------------------------------------------------------------------------
# Lines past one block and three-factor splits (csrc/long_lines.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl,split", [
    ("matmul", None), ("stockham", None), ("matmul", (32, 16, 16))])
@pytest.mark.parametrize("fwd,inv", DIRS)
@pytest.mark.parametrize("n", [8192, 32768])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_long_lines_match_plain(cuda_device, mode, axis, n, fwd, inv,
                                     fft_impl, split):
    """The device-memory passes in one launch against the plain version:
    the Stockham route bit for bit, the matmul route within TOL."""
    if mode == "none" and not (fwd or inv):
        pytest.skip("no op")
    if split is not None and n != 8192:
        pytest.skip("the split is of 8192")
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    x, filt = make_case(cuda_device, n + axis, mode, axis, n, 2, lines=5)
    before = ops.SPECTRAL_LAUNCHES
    got = ops.spectral_op(*x, **filt, axis=axis, fwd=fwd, inv=inv,
                          filter_mode=mode, fft_impl=fft_impl, block=1, **kw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    want = ops.spectral_op_plain(*x, **filt, axis=axis, fwd=fwd, inv=inv,
                                 filter_mode=mode, fft_impl=fft_impl,
                                 block=1, **kw)
    if fft_impl == "stockham":
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n", [8192, 32768])
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_long_lines_match_complex128(cuda_device, axis, n, fft_impl):
    x, filt = make_case(cuda_device, 3, "shared", axis, n, 1, lines=5)
    got = ops.spectral_op(*x, **filt, axis=axis, fwd=True, inv=True,
                          filter_mode="shared", fft_impl=fft_impl)
    dim = -1 if axis == 1 else -2
    z = torch.complex(x[0].double(), x[1].double())
    h = torch.complex(filt["hr"].double(), filt["hi"].double())
    h = h[None, :] if axis == 1 else h[:, None]
    want = torch.fft.ifft(torch.fft.fft(z, dim=dim) * h, dim=dim)
    g = torch.complex(got[0].double(), got[1].double())
    assert float((g - want).abs().max()) <= ORACLE_TOL * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("shape", [(8192, 64), (64, 8192)])
def test_cuda_staged_long_segments_equal_three_launches(cuda_device, shape,
                                                       fft_impl):
    na, nr = shape
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)

    def rand(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    x = (rand(1, na, nr), rand(1, na, nr))
    args = [rand(nr), rand(nr), rand(na, nr), rand(na, nr)]
    segs = ((0, True, False, "none"), (1, True, True, "shared"),
            (0, False, True, "full"))
    before = ops.MEGA_LAUNCHES["mega_staged"]
    got = ops.mega_spectral_op(*x, *args, segments=segs, residency="staged",
                               fft_impl=fft_impl)
    torch.cuda.synchronize()
    assert ops.MEGA_LAUNCHES["mega_staged"] == before + 1
    y = ops.spectral_op(*x, axis=0, fwd=True, inv=False, fft_impl=fft_impl)
    y = ops.spectral_op(*y, hr=args[0], hi=args[1], axis=1, fwd=True,
                        inv=True, filter_mode="shared", fft_impl=fft_impl)
    y = ops.spectral_op(*y, hr=args[2], hi=args[3], axis=0, fwd=False,
                        inv=True, filter_mode="full", fft_impl=fft_impl)
    assert all(torch.equal(g, w) for g, w in zip(got, y))
    want = ops.mega_spectral_op_plain(*x, *args, segments=segs,
                                      residency="staged", fft_impl=fft_impl)
    assert_close(got, want)


# every form past one block besides plain f32: (precision, karatsuba)
LONG_FORMS = [("bf16", False), ("f16", False), ("bs16", False),
              ("f32", True), ("bs16", True)]


def assert_close_finite(got, want, tol):
    """Equal non-finite masks (f16's range overflows alike in the kernel
    and the plain version), and within ``tol`` x max|want| elsewhere."""
    for g, w in zip(got, want):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
    fin = [torch.isfinite(w) for w in want]
    assert_close([g[f] for g, f in zip(got, fin)],
                 [w[f] for w, f in zip(want, fin)], tol)


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl,split", [
    ("matmul", None), ("stockham", None), ("matmul", (32, 16, 16)),
    ("matmul", (16, 16, 16))])
@pytest.mark.parametrize("n", [8192, 16384])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("precision,karatsuba", LONG_FORMS)
def test_cuda_long_forms_match_plain(cuda_device, precision, karatsuba, axis,
                                     n, fft_impl, split):
    """Every form past one block in one launch against the plain version:
    the matmul route within FORM_TOL, the Stockham route bit for bit (bs16
    with odd lines subnormal)."""
    if split is not None and n != 8192:
        pytest.skip("a split of its own length")
    if fft_impl == "stockham" and karatsuba:
        pytest.skip("no matrix operand on the Stockham route")
    nn = split[0] * split[1] * split[2] if split else n
    kw = dict(zip(("n1", "n2", "n3"), split)) if split else {}
    for mode, fwd, inv in (("shared_outer", True, True), ("none", True, False),
                           ("full", False, True), ("full", False, False)):
        x, filt = make_case(cuda_device, nn + axis, mode, axis, nn, 2,
                            lines=5)
        if precision == "bs16":
            x = subnormal_lines(x, axis)
        args = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
                    fft_impl=fft_impl, precision=precision,
                    karatsuba=karatsuba, **kw)
        before = ops.SPECTRAL_LAUNCHES
        got = ops.spectral_op(*x, **filt, **args)
        torch.cuda.synchronize()
        assert ops.SPECTRAL_LAUNCHES == before + 1
        want = ops.spectral_op_plain(*x, **filt, **args)
        if fft_impl == "stockham":
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            assert_close_finite(got, want, FORM_TOL[precision])


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("shape", [(8192, 64), (64, 8192)])
@pytest.mark.parametrize("precision,karatsuba", LONG_FORMS)
def test_cuda_staged_long_forms_equal_three_launches(cuda_device, shape,
                                                    fft_impl, precision,
                                                    karatsuba):
    """mega_staged with segments past one block at every form: bit for bit
    its three spectral launches (the same passes), within FORM_TOL of the
    plain version."""
    if fft_impl == "stockham" and karatsuba:
        pytest.skip("no matrix operand on the Stockham route")
    na, nr = shape
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(13)

    def rand(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    x = (rand(1, na, nr), rand(1, na, nr))
    args = [rand(nr), rand(nr), rand(na, nr), rand(na, nr)]
    segs = ((0, True, False, "none"), (1, True, True, "shared"),
            (0, False, True, "full"))
    kw = dict(fft_impl=fft_impl, precision=precision, karatsuba=karatsuba)
    before = ops.MEGA_LAUNCHES["mega_staged"]
    got = ops.mega_spectral_op(*x, *args, segments=segs, residency="staged",
                               **kw)
    torch.cuda.synchronize()
    assert ops.MEGA_LAUNCHES["mega_staged"] == before + 1
    y = ops.spectral_op(*x, axis=0, fwd=True, inv=False, **kw)
    y = ops.spectral_op(*y, hr=args[0], hi=args[1], axis=1, fwd=True,
                        inv=True, filter_mode="shared", **kw)
    y = ops.spectral_op(*y, hr=args[2], hi=args[3], axis=0, fwd=False,
                        inv=True, filter_mode="full", **kw)
    # bit for bit, NaN payloads included (each launch re-takes bs16's
    # exponents, as each segment does)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, y))
    want = ops.mega_spectral_op_plain(*x, *args, segments=segs,
                                      residency="staged", **kw)
    assert_close_finite(got, want, FORM_TOL[precision])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,fft_kw", [((128, 128), dict(n1=8, n2=4, n3=4)),
                                          ((2, 8192), None)])
def test_cuda_residency_cut_runs_long_lines_resident(cuda_device, shape,
                                                     fft_kw):
    """A scene that fits one block's shared memory but holds a line past
    one block (a three-factor split, or 8192 points) compiles fused1 to
    mega_resident with no residency pinned and runs it in one launch, bit
    for bit fused3's image and a pinned staged fused1's (one
    mega_staged launch)."""
    import dataclasses

    from repro_torch.core.sar import build_pipeline
    from repro_torch.core.sar.geometry import test_scene
    cfg = dataclasses.replace(test_scene(128), na=shape[0], nr=shape[1])
    kw = dict(fft_kw=fft_kw) if fft_kw else {}
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(8)
    raw = torch.complex(
        torch.randn(shape, generator=gen, device=cuda_device),
        torch.randn(shape, generator=gen, device=cuda_device))
    one = build_pipeline(cfg, "fused1", **kw)
    assert one.steps[0].kernel_kw["residency"] == "vmem"
    before = dict(ops.MEGA_LAUNCHES)
    got = one.run(raw)
    torch.cuda.synchronize()
    assert ops.MEGA_LAUNCHES["mega_resident"] == \
        before["mega_resident"] + 1
    want = build_pipeline(cfg, "fused3", **kw).run(raw)
    assert torch.equal(got, want)
    staged = build_pipeline(cfg, "fused1", residency="staged", **kw)
    before = dict(ops.MEGA_LAUNCHES)
    assert torch.equal(staged.run(raw), got)
    torch.cuda.synchronize()
    assert ops.MEGA_LAUNCHES["mega_staged"] == before["mega_staged"] + 1


# mega_resident past one block: (batch, na, nr, batch_block, range split)
RESIDENT_LONG = [(1, 2, 8192, None, None), (1, 8192, 2, None, None),
                 (1, 1, 16384, None, None), (1, 16384, 1, None, None),
                 (1, 128, 128, None, (8, 4, 4)), (4, 64, 64, 2, None),
                 (2, 2, 8192, None, None), (2, 1, 8192, 2, None)]
# fused1's chain and one with one-direction segments, every filter mode
# across them
RESIDENT_CHAINS = (((0, True, False, "none"), (1, True, True, "shared_outer"),
                    (0, False, True, "outer")),
                   ((1, True, False, "outer"), (0, True, True, "full"),
                    (1, False, True, "none")))


def resident_chains(na, nr, fft_impl):
    """RESIDENT_CHAINS; on the Stockham route, which transforms no 1-point
    line (nor does its plain version), a 1-point axis only filtered."""
    out = []
    for chain in RESIDENT_CHAINS:
        if fft_impl == "stockham":
            chain = tuple(
                (a, False, False, m if m != "none" else "full")
                if (nr if a == 1 else na) == 1 else (a, f, i, m)
                for a, f, i, m in chain)
        out.append(chain)
    return out


def oracle_mega(x, segments, args):
    """A chain in complex128: torch.fft and the filters' definitions."""
    z = torch.complex(x[0].double(), x[1].double())
    it = iter(a.double() for a in args)
    for axis, fwd, inv, mode in segments:
        dim = -1 if axis == 1 else -2
        if fwd:
            z = torch.fft.fft(z, dim=dim)
        if mode in ("shared", "full", "shared_outer"):
            h = torch.complex(next(it), next(it))
            if mode != "full":
                h = h[None, :] if axis == 1 else h[:, None]
            z = z * h
        if mode in ("outer", "shared_outer"):
            u, v = next(it), next(it)
            ph = u @ v.T if axis == 1 else v @ u.T   # (na, nr)
            z = z * torch.polar(torch.ones_like(ph), ph)
        if inv:
            z = torch.fft.ifft(z, dim=dim)
    return z


def three_launches(x, segments, args, **kw):
    """The chain as one spectral launch a segment (fused3's form)."""
    it = iter(args)
    y = x
    for axis, fwd, inv, mode in segments:
        filt = {}
        if mode in ("shared", "full", "shared_outer"):
            filt.update(hr=next(it), hi=next(it))
        if mode in ("outer", "shared_outer"):
            filt.update(u=next(it), v=next(it))
        # the split is the range axis's (fft_kw's); a filter-only launch
        # has no route (the spectral launcher's Stockham check refuses a
        # 1-point line it would not transform)
        seg = {k: v for k, v in kw.items()
               if axis == 1 or k not in ("n1", "n2", "n3")}
        if not (fwd or inv):
            seg["fft_impl"] = "matmul"
        y = ops.spectral_op(*y, **filt, axis=axis, fwd=fwd, inv=inv,
                            filter_mode=mode, **seg)
    return y


def bits_equal(a, b):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("precision,karatsuba",
                         [("f32", False)] + LONG_FORMS)
@pytest.mark.parametrize("case", RESIDENT_LONG)
def test_cuda_resident_long_equals_staged_and_three_launches(
        cuda_device, case, precision, karatsuba, fft_impl):
    """mega_resident past one block (lines of 8192 and 16384 points, a
    three-factor split, batch_block scenes a block) in one launch at every
    form: bit for bit mega_staged and the three spectral launches (and,
    batch_block > 1, the one-scene blocks), within FORM_TOL of the plain
    version (the Stockham route bit for bit), f32 within ORACLE_TOL of
    complex128."""
    if fft_impl == "stockham" and karatsuba:
        pytest.skip("no matrix operand on the Stockham route")
    batch, na, nr, bb, split = case
    kw = dict(fft_impl=fft_impl, precision=precision, karatsuba=karatsuba)
    if split:
        kw.update(zip(("n1", "n2", "n3"), split))
    for k, segs in enumerate(resident_chains(na, nr, fft_impl)):
        x, args = make_mega_case(cuda_device, 17 + k, segs, batch, na, nr)
        before = ops.MEGA_LAUNCHES["mega_resident"]
        got = ops.mega_spectral_op(*x, *args, segments=segs,
                                   residency="vmem", batch_block=bb, **kw)
        torch.cuda.synchronize()
        assert ops.MEGA_LAUNCHES["mega_resident"] == before + 1
        assert bits_equal(got, ops.mega_spectral_op(
            *x, *args, segments=segs, residency="staged", **kw))
        assert bits_equal(got, three_launches(x, segs, args, **kw))
        if bb:
            assert bits_equal(got, ops.mega_spectral_op(
                *x, *args, segments=segs, residency="vmem", **kw))
        want = ops.mega_spectral_op_plain(*x, *args, segments=segs,
                                          residency="vmem", **kw)
        if fft_impl == "stockham":
            assert bits_equal(got, want)
        else:
            assert_close_finite(got, want, FORM_TOL[precision])
        if precision == "f32" and not karatsuba:
            assert_oracle(got, oracle_mega(x, segs, args))


# ---------------------------------------------------------------------------
# Whole-line tiles (rows, one device-memory digit, N <= 16384) and the
# passes' 16-byte tile I/O (csrc/long_lines.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bs16"])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n,axis,lines", [(8192, 1, 5), (16384, 1, 5),
                                          (8192, 0, 8), (8192, 0, 5)])
def test_cuda_whole_lines_match_plain_and_complex128(cuda_device, n, axis,
                                                     lines, fft_impl,
                                                     precision):
    """Rows of 8192 and 16384 points in whole-line tiles (one pass over
    device memory), columns of 8192 through the passes (16-byte tile
    I/O where the lines come in fours, 8; the one-point loop, 5): every
    direction and the filter-only pass against the plain version, the
    Stockham route bit for bit (bs16 with odd lines subnormal), the
    matmul route within FORM_TOL; f32 within ORACLE_TOL of complex128."""
    from repro_torch.kernels.fft4step import SpectralSpec
    g = ops.long_geometry(SpectralSpec(n=n, fwd=True, inv=True,
                                       filter_mode="full", axis=axis,
                                       fft_impl=fft_impl,
                                       precision=precision))
    assert g.whole_line == (axis == 1) and g.passes(True, True) == (
        1 if axis == 1 else g.tile_passes(True, True))
    for mode, fwd, inv in (("shared_outer", True, True), ("full", True, False),
                           ("outer", False, True), ("full", False, False)):
        x, filt = make_case(cuda_device, n + 7 * axis + lines, mode, axis,
                            n, 2, lines=lines)
        if precision == "bs16":
            x = subnormal_lines(x, axis)
        args = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
                    fft_impl=fft_impl, precision=precision)
        before = ops.SPECTRAL_LAUNCHES
        got = ops.spectral_op(*x, **filt, **args)
        torch.cuda.synchronize()
        assert ops.SPECTRAL_LAUNCHES == before + 1
        want = ops.spectral_op_plain(*x, **filt, **args)
        if fft_impl == "stockham":
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        else:
            assert_close_finite(got, want, FORM_TOL[precision])
    if precision == "f32":
        x, filt = make_case(cuda_device, 3, "shared", axis, n, 1,
                            lines=lines)
        got = ops.spectral_op(*x, **filt, axis=axis, fwd=True, inv=True,
                              filter_mode="shared", fft_impl=fft_impl)
        dim = -1 if axis == 1 else -2
        z = torch.complex(x[0].double(), x[1].double())
        h = torch.complex(filt["hr"].double(), filt["hi"].double())
        h = h[None, :] if axis == 1 else h[:, None]
        want = torch.fft.ifft(torch.fft.fft(z, dim=dim) * h, dim=dim)
        zg = torch.complex(got[0].double(), got[1].double())
        assert float((zg - want).abs().max()) <= ORACLE_TOL * float(
            want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bs16"])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("shape", [(4, 8192), (2, 16384), (8192, 4),
                                   (2, 8192), (1, 16384)])
def test_cuda_whole_line_chains_equal_three_launches_and_resident(
        cuda_device, shape, fft_impl, precision):
    """mega_staged's long segments (rows in whole-line tiles, columns
    through the passes) bit for bit their three spectral launches, and,
    where the scene fits one block (2 x 8192, 1 x 16384), mega_resident's
    slab passes bit for bit mega_staged: fused1's chain and one with
    one-direction segments."""
    na, nr = shape
    kw = dict(fft_impl=fft_impl, precision=precision)
    for k, segs in enumerate(resident_chains(na, nr, fft_impl)):
        x, args = make_mega_case(cuda_device, 31 + k, segs, 1, na, nr)
        before = ops.MEGA_LAUNCHES["mega_staged"]
        staged = ops.mega_spectral_op(*x, *args, segments=segs,
                                      residency="staged", **kw)
        torch.cuda.synchronize()
        assert ops.MEGA_LAUNCHES["mega_staged"] == before + 1
        assert bits_equal(staged, three_launches(x, segs, args, **kw))
        if na * nr <= ops.RESIDENT_MAX_POINTS:
            assert bits_equal(ops.mega_spectral_op(
                *x, *args, segments=segs, residency="vmem", **kw), staged)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f32", "bs16"])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n,axis,lines", [(8192, 0, 8), (8192, 0, 5),
                                          (32768, 1, 3)])
def test_cuda_ring_equals_loads_without_it(cuda_device, monkeypatch, n,
                                           axis, lines, fft_impl,
                                           precision):
    """The tile passes' asynchronous ring (``ops.LONG_RING``, its tiles
    sized for it) and their loads without it give the same bits, in every
    direction and in mega_staged's long segments."""
    outs = {}
    for ring in (True, False):
        monkeypatch.setattr(ops, "LONG_RING", ring)
        got = []
        for mode, fwd, inv in (("shared", True, True), ("full", True, False),
                               ("outer", False, True)):
            x, filt = make_case(cuda_device, n + lines, mode, axis, n, 2,
                                lines=lines)
            got += ops.spectral_op(*x, **filt, axis=axis, fwd=fwd, inv=inv,
                                   filter_mode=mode, fft_impl=fft_impl,
                                   precision=precision)
        if axis == 0 and lines == 8:
            segs = resident_chains(n, lines, fft_impl)[0]
            x, args = make_mega_case(cuda_device, 41, segs, 1, n, lines)
            got += ops.mega_spectral_op(*x, *args, segments=segs,
                                        residency="staged",
                                        fft_impl=fft_impl,
                                        precision=precision)
        torch.cuda.synchronize()
        outs[ring] = got
    assert bits_equal(outs[True], outs[False])


# ---------------------------------------------------------------------------
# The megakernels (csrc/mega.cu)
# ---------------------------------------------------------------------------

MEGA_CHAINS = {
    "fused1": ((0, True, False, "none"), (1, True, True, "shared_outer"),
               (0, False, True, "outer")),
    "full_shared": ((0, True, False, "none"), (1, True, True, "full"),
                    (0, False, True, "shared")),
    "same_axis": ((1, True, False, "shared"), (1, False, True, "full"),
                  (0, True, True, "outer")),
    "one_segment": ((0, True, True, "shared_outer"),),
}
# the CSA and omega-K chains, and filter-only segments (the codec through
# shared memory)
BS16_CHAINS = {
    "csa": ((0, True, False, "full"), (1, True, True, "full"),
            (0, False, True, "full")),
    "omegak": ((0, True, False, "none"), (1, True, True, "full"),
               (0, False, True, "outer")),
    "filter_only": ((1, False, False, "full"), (0, True, True, "shared"),
                    (1, False, False, "outer")),
}


def make_mega_case(device, seed, segments, batch, na, nr, rank=2):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = (rand(batch, na, nr), rand(batch, na, nr))
    args = []
    for axis, _fwd, _inv, mode in segments:
        n, lines = (nr, na) if axis == 1 else (na, nr)
        if mode in ("shared", "shared_outer"):
            args += [rand(n), rand(n)]
        if mode == "full":
            args += [rand(na, nr), rand(na, nr)]
        if mode in ("outer", "shared_outer"):
            args += [0.1 * rand(lines, rank), rand(n, rank)]
    return x, args


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shape", [(64, 128), (128, 64), (128, 128),
                                   (256, 512)])
@pytest.mark.parametrize("chain", sorted(MEGA_CHAINS))
def test_cuda_megakernels_match_plain(cuda_device, chain, shape, batch,
                                      fft_impl):
    segments = MEGA_CHAINS[chain]
    x, args = make_mega_case(cuda_device, 1, segments, batch, *shape)
    want = ops.mega_spectral_op_plain(*x, *args, segments=segments,
                                      fft_impl=fft_impl)
    outs = []
    for residency in ("vmem", "staged"):
        if residency == "vmem" and ops.mega_residency(*shape) != "vmem":
            continue
        kernel = "mega_resident" if residency == "vmem" else "mega_staged"
        before = ops.MEGA_LAUNCHES[kernel]
        got = ops.mega_spectral_op(*x, *args, segments=segments,
                                   residency=residency, fft_impl=fft_impl)
        torch.cuda.synchronize()
        assert ops.MEGA_LAUNCHES[kernel] == before + 1
        assert_close(got, want)
        outs.append(got)
    if len(outs) == 2:
        assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n", [128, 256])
def test_cuda_fused1_equals_fused3(cuda_device, n, fft_impl):
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(n)
    raw = simulate(cfg, paper_targets(cfg))
    f3 = build_pipeline(cfg, "fused3", fft_impl=fft_impl).run(raw)
    kernel = "mega_resident" if n == 128 else "mega_staged"
    before = dict(ops.MEGA_LAUNCHES), ops.SPECTRAL_LAUNCHES
    f1 = build_pipeline(cfg, "fused1", fft_impl=fft_impl).run(raw)
    torch.cuda.synchronize()
    before[0][kernel] += 1
    assert (ops.MEGA_LAUNCHES, ops.SPECTRAL_LAUNCHES) == before
    assert torch.equal(f1, f3)
    staged = build_pipeline(cfg, "fused1", residency="staged",
                            fft_impl=fft_impl).run(raw)
    assert torch.equal(staged, f3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 128), (128, 64), (128, 128),
                                   (256, 512)])
@pytest.mark.parametrize("chain", sorted(MEGA_CHAINS) + ["csa", "omegak",
                                                          "filter_only"])
def test_cuda_megakernels_bs16_match_plain(cuda_device, chain, shape):
    """bs16 through both megakernels on the Stockham route (the codec in
    every segment), on a batch of a unit-scale scene beside a subnormal
    one: equal to the plain version bit for bit, resident to staged, and
    different from f32 on the subnormal scene alone."""
    segments = {**MEGA_CHAINS, **BS16_CHAINS}[chain]
    x, args = make_mega_case(cuda_device, 4, segments, 2, *shape)
    for t in x:
        t[1] *= 1e-40
    kw = dict(segments=segments, fft_impl="stockham")
    want = ops.mega_spectral_op_plain(*x, *args, precision="bs16", **kw)
    outs = []
    for residency in ("vmem", "staged"):
        if residency == "vmem" and ops.mega_residency(*shape) != "vmem":
            continue
        kernel = "mega_resident" if residency == "vmem" else "mega_staged"
        before = ops.MEGA_LAUNCHES[kernel]
        got = ops.mega_spectral_op(*x, *args, residency=residency,
                                   precision="bs16", **kw)
        torch.cuda.synchronize()
        assert ops.MEGA_LAUNCHES[kernel] == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        f32 = ops.mega_spectral_op(*x, *args, residency=residency, **kw)
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, f32))
        assert not all(torch.equal(g[1], w[1]) for g, w in zip(got, f32))
        for precision in ("bf16", "f16"):
            narrow = ops.mega_spectral_op(*x, *args, residency=residency,
                                          precision=precision, **kw)
            assert all(torch.equal(g, w) for g, w in zip(narrow, f32))
        outs.append(got)
    if len(outs) == 2:
        assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [None, "bs16"])
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("variant,twin", [("csa_fused1", "csa_fused"),
                                          ("omegak_fused1", "omegak")])
def test_cuda_csa_omegak_fused1_equals_twin(cuda_device, variant, twin, n,
                                            fft_impl, precision):
    """CSA and omega-K in one megakernel launch (FULL screens read from
    device memory) equal their three spectral launches bit for bit."""
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(n)
    raw = simulate(cfg, paper_targets(cfg))
    kw = dict(fft_impl=fft_impl, precision=precision)
    before = ops.SPECTRAL_LAUNCHES
    three = build_pipeline(cfg, twin, **kw).run(raw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 3
    kernel = "mega_resident" if n == 128 else "mega_staged"
    before = dict(ops.MEGA_LAUNCHES), ops.SPECTRAL_LAUNCHES
    one = build_pipeline(cfg, variant, **kw).run(raw)
    torch.cuda.synchronize()
    before[0][kernel] += 1
    assert (ops.MEGA_LAUNCHES, ops.SPECTRAL_LAUNCHES) == before
    assert torch.isfinite(one).all()
    assert torch.equal(one, three)
    staged = build_pipeline(cfg, variant, residency="staged", **kw).run(raw)
    assert torch.equal(staged, three)


@pytest.mark.gpu
def test_cuda_precisions_refused_on_the_matmul_route_alone(cuda_device):
    """Both routes take bf16, f16 and bs16 now (the name predates the
    matmul route's forms): each precision launches once a route and
    kernel, within its tolerance of the plain version."""
    x, _ = make_case(cuda_device, 6, "none", 1, 64, 1, lines=4)
    segments = MEGA_CHAINS["fused1"]
    mx, margs = make_mega_case(cuda_device, 6, segments, 1, 64, 64)
    before = ops.SPECTRAL_LAUNCHES, dict(ops.MEGA_LAUNCHES)
    for precision in ("bf16", "f16", "bs16"):
        for fft_impl in ("matmul", "stockham"):
            kw = dict(precision=precision, fft_impl=fft_impl)
            got = ops.fft_rows(*x, **kw)
            torch.cuda.synchronize()
            assert_close(got, ops.spectral_op_plain(
                *x, fwd=True, inv=False, **kw), FORM_TOL[precision])
            got = ops.mega_spectral_op(*mx, *margs, segments=segments, **kw)
            torch.cuda.synchronize()
            assert_close(got, ops.mega_spectral_op_plain(
                *mx, *margs, segments=segments, **kw), FORM_TOL[precision])
    assert ops.SPECTRAL_LAUNCHES == before[0] + 6
    assert ops.MEGA_LAUNCHES["mega_resident"] == \
        before[1]["mega_resident"] + 6


@pytest.mark.gpu
def test_cuda_megakernels_refuse_and_never_fall_back(cuda_device):
    segments = MEGA_CHAINS["fused1"]
    x, args = make_mega_case(cuda_device, 2, segments, 1, 64, 64)
    big, big_args = make_mega_case(cuda_device, 2, segments, 1, 256, 256)
    before = dict(ops.MEGA_LAUNCHES)
    with pytest.raises(ValueError, match="does not fit"):
        ops.mega_spectral_op(*big, *big_args, segments=segments,
                             residency="vmem")
    with pytest.raises(ValueError, match="ROADMAP"):
        ops.mega_spectral_op(*x, *args, segments=segments,
                             fft_impl="bluestein")
    assert ops.MEGA_LAUNCHES == before
    # the Stockham route and the matmul route's bs16 and Karatsuba,
    # refused before, now launch
    for kw in (dict(fft_impl="stockham"), dict(precision="bs16"),
               dict(karatsuba=True)):
        got = ops.mega_spectral_op(*x, *args, segments=segments, **kw)
        torch.cuda.synchronize()
        before["mega_resident"] += 1
        assert ops.MEGA_LAUNCHES == before
        assert_close(got, ops.mega_spectral_op_plain(
            *x, *args, segments=segments, **kw),
            FORM_TOL[kw.get("precision", "f32")])


# ---------------------------------------------------------------------------
# The matmul route's operand forms: bf16 / f16 / bs16 and Karatsuba
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("split", [None, (128, 32)])
@pytest.mark.parametrize("n", [128, 4096])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", ["none", "shared_outer", "full"])
@pytest.mark.parametrize("precision,karatsuba", FORMS)
def test_cuda_matmul_forms_match_plain(cuda_device, precision, karatsuba,
                                       mode, axis, n, split):
    """Each operand form of the spectral kernel against its plain version,
    fwd / inv / fwd+inv (bs16 on a batch with subnormal odd lines, which
    the codec keeps to the tolerance of their own scale); f32 with
    Karatsuba against complex128 too at N = 4096."""
    if split is not None and n != 4096:
        pytest.skip("the (128, 32) split is a split of 4096")
    x, filt = make_case(cuda_device, n + 7, mode, axis, n, 2, lines=13)
    if precision == "bs16":
        x = subnormal_lines(x, axis)
    n1, n2 = split or (None, None)
    tol = FORM_TOL[precision]
    for fwd, inv in DIRS[:3]:
        kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode, block=1,
                  precision=precision, karatsuba=karatsuba, n1=n1, n2=n2)
        before = ops.SPECTRAL_LAUNCHES
        got = ops.spectral_op(*x, **filt, **kw)
        torch.cuda.synchronize()
        assert ops.SPECTRAL_LAUNCHES == before + 1
        want = ops.spectral_op_plain(*x, **filt, **kw)
        assert_close(got, want, tol)
        if precision == "bs16":
            odd = ((slice(None), slice(1, None, 2)) if axis == 1 else
                   (slice(None), slice(None), slice(1, None, 2)))
            assert_close([g[odd] for g in got], [w[odd] for w in want], tol)
        if precision == "f32" and n == 4096 and mode == "none":
            z = torch.complex(x[0].double(), x[1].double())
            assert_oracle(got, fft128(z, -1 if axis == 1 else -2, fwd, inv))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 128), (128, 128), (256, 512)])
@pytest.mark.parametrize("precision,karatsuba", FORMS)
def test_cuda_megakernel_forms_match_plain(cuda_device, precision,
                                           karatsuba, shape):
    """Both megakernels at each operand form against the plain version,
    resident equal to staged bit for bit; Karatsuba also per segment
    (8-field records, the middle segment without it)."""
    segments = MEGA_CHAINS["fused1"]
    x, args = make_mega_case(cuda_device, 9, segments, 2, *shape)
    per_seg = tuple(rec + (None, None, None, karatsuba and i != 1)
                    for i, rec in enumerate(segments))
    for segs in (segments, per_seg):
        kw = dict(segments=segs, precision=precision, karatsuba=karatsuba)
        want = ops.mega_spectral_op_plain(*x, *args, **kw)
        outs = []
        for residency in ("vmem", "staged"):
            if residency == "vmem" and ops.mega_residency(*shape) != "vmem":
                continue
            kernel = "mega_resident" if residency == "vmem" else \
                "mega_staged"
            before = ops.MEGA_LAUNCHES[kernel]
            got = ops.mega_spectral_op(*x, *args, residency=residency, **kw)
            torch.cuda.synchronize()
            assert ops.MEGA_LAUNCHES[kernel] == before + 1
            assert_close(got, want, FORM_TOL[precision])
            outs.append(got)
        if len(outs) == 2:
            assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
@pytest.mark.parametrize("karatsuba", [False, True])
@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
@pytest.mark.parametrize("n", [128, 256])
def test_cuda_matmul_fused1_equals_fused3(cuda_device, n, precision,
                                          karatsuba):
    """The matmul route's fused1 equals its fused3 bit for bit at every
    narrowed precision, with and without Karatsuba (a Schedule giving it
    to every segment: each launch of fused3, each in-kernel segment of
    fused1), resident and staged. f16 overflows its range on these scenes
    (in the plain version and the JAX reference too:
    tests/test_torch_rda.py); its non-finite points are held bit for bit
    as well."""
    from repro_torch import tuning
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(n)
    raw = simulate(cfg, paper_targets(cfg))
    sched = tuning.Schedule(
        segments=(tuning.SegmentConfig(karatsuba=karatsuba),) * 3)
    kw = dict(precision=precision, schedule=sched, tune="off")
    f3 = build_pipeline(cfg, "fused3", **kw).run(raw)
    kernel = "mega_resident" if n == 128 else "mega_staged"
    before = dict(ops.MEGA_LAUNCHES), ops.SPECTRAL_LAUNCHES
    f1 = build_pipeline(cfg, "fused1", **kw).run(raw)
    torch.cuda.synchronize()
    before[0][kernel] += 1
    assert (ops.MEGA_LAUNCHES, ops.SPECTRAL_LAUNCHES) == before
    assert bool(torch.isfinite(f1).all()) == (precision != "f16")

    def bits(z):
        return torch.view_as_real(z).view(torch.int32)

    assert torch.equal(bits(f1), bits(f3))
    staged = build_pipeline(cfg, "fused1", residency="staged", **kw).run(raw)
    assert torch.equal(bits(staged), bits(f3))


@pytest.mark.gpu
def test_cuda_tiny_search_persists_and_compiles(cuda_device, tmp_path,
                                                monkeypatch):
    """A small search_kernel on the card times fewer candidates than its
    space, persists its winner, and compile_plan reads it back into the
    range launch of a fused3 pipeline."""
    from repro_torch import tuning
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.core.sar.geometry import test_scene
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    tuning.clear_memory_cache()
    planlib.clear_pipeline_cache()
    key = tuning.TuneKey.kernel(128, lines=16)
    assert key.backend == "cuda"
    res = tuning.search_kernel(key, precisions=("f32", "bf16"),
                               gate=lambda p: 0.0)
    assert res.measured < res.space
    assert tuning.cached_config(128) == res.config
    pipe = build_pipeline(test_scene(128), "fused3")
    (row,) = [s for s in pipe.steps if s.phys_axis == 1]
    kk = row.kernel_kw
    want = res.config
    assert (kk["n1"], kk["n2"], kk["karatsuba"], kk["precision"],
            kk["block"]) == (want.n1, want.n2, bool(want.karatsuba),
                             want.precision or "f32", want.block)
    tuning.clear_memory_cache()
    planlib.clear_pipeline_cache()


# ---------------------------------------------------------------------------
# The tiled transpose (csrc/transpose.cu) and the fused variant
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("shape", [(64, 64), (128, 256), (96, 32), (37, 4096),
                                   (7, 5), (4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_cuda_transpose_equals_plain(cuda_device, dtype, shape, batch):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(shape[0] * 7 + shape[1])
    full = shape if batch is None else (batch, *shape)
    x = torch.randn(full, generator=gen, device=cuda_device, dtype=dtype)
    before = tr.TRANSPOSE_LAUNCHES
    got = tr.transpose(x)
    torch.cuda.synchronize()
    assert tr.TRANSPOSE_LAUNCHES == before + 1
    assert torch.equal(got, tr.transpose_plain(x))
    assert torch.equal(got, x.transpose(-1, -2))


@pytest.mark.gpu
def test_cuda_transpose_refuses_other_dtypes(cuda_device):
    before = tr.TRANSPOSE_LAUNCHES
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(ValueError, match="float32 or complex64"):
            tr.transpose(torch.zeros(4, 8, dtype=dtype, device=cuda_device))
    assert tr.TRANSPOSE_LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("na", [128, 256])
def test_cuda_fused_launches_and_matches_plain_replay(cuda_device, na):
    import dataclasses
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    cfg = dataclasses.replace(test_scene(128), na=na)
    raw = simulate(cfg, paper_targets(cfg))
    pipe = build_pipeline(cfg, "fused")
    before = (ops.SPECTRAL_LAUNCHES, tr.TRANSPOSE_LAUNCHES,
              dict(ops.MEGA_LAUNCHES))
    img = pipe.run(raw)
    torch.cuda.synchronize()
    assert (ops.SPECTRAL_LAUNCHES, tr.TRANSPOSE_LAUNCHES,
            ops.MEGA_LAUNCHES) == (before[0] + 3, before[1] + 4, before[2])
    on_cpu = build_pipeline(cfg, "fused", device="cpu").run(raw.cpu())
    assert_close((img.real.cpu(), img.imag.cpu()),
                 (on_cpu.real, on_cpu.imag))


# ---------------------------------------------------------------------------
# The streaming executor and the focusing service on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("strips", [1, 3, 4])
@pytest.mark.parametrize("variant,fft_impl,precision", [
    ("fused3", "matmul", None), ("fused3", "stockham", None),
    ("fused3", "matmul", "bs16"), ("csa_fused", "matmul", None),
    ("omegak", "matmul", None), ("unfused", "matmul", None)])
def test_cuda_run_streamed_equals_run(cuda_device, variant, fft_impl,
                                      precision, strips):
    """Strips through pinned memory and a copy stream give the in-memory
    image bit for bit, each strip one launch a spectral step."""
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(256)
    raw = simulate(cfg, paper_targets(cfg))
    kw = {} if variant == "unfused" else dict(fft_impl=fft_impl,
                                              precision=precision)
    pipe = build_pipeline(cfg, variant, **kw)
    want = pipe.run(raw).cpu()
    spectral = sum(s.kind == "spectral" for s in pipe.steps)
    before = ops.SPECTRAL_LAUNCHES
    got = pipe.run_streamed(raw.cpu().numpy(), strips=strips)
    launched = ops.SPECTRAL_LAUNCHES - before
    assert launched == (0 if variant == "unfused" else spectral * strips)
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.gpu
def test_cuda_service_round_trip(cuda_device):
    """One burst of 128^2 default-tier requests through the service on
    the card: one coalesced batch through ``mega_resident`` alone, each
    image bit-equal to fused1 at the tier the gate admitted."""
    import asyncio

    import numpy as np
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.geometry import test_scene
    from repro_torch.service import FocusService, LocalBackend, ServiceConfig
    cfg = test_scene(128)
    raw = simulate(cfg, paper_targets(cfg)).cpu().numpy()
    scenes = [raw * (1 + 0.1 * i) for i in range(4)]

    async def main():
        svc = FocusService(ServiceConfig(max_delay_ms=200.0),
                           backend=LocalBackend(sweep=((None, None),)))
        await svc.start(warm=[(cfg, "fused3", None)])
        await svc._ensure_gate_measured("bs16")
        before = (ops.SPECTRAL_LAUNCHES, dict(ops.MEGA_LAUNCHES))
        outs = await asyncio.gather(*[svc.focus(s, cfg) for s in scenes])
        after = (ops.SPECTRAL_LAUNCHES, dict(ops.MEGA_LAUNCHES))
        await svc.stop()
        return outs, before, after, svc

    outs, before, after, svc = asyncio.run(main())
    snap = svc.metrics.snapshot()
    tier = "f32" if snap["tier_fallbacks"] else "bs16"
    assert snap["batch_size_hist"] == {4: 1}
    assert not svc.backend.fallbacks
    assert after[0] == before[0]
    assert after[1]["mega_resident"] == before[1]["mega_resident"] + 1
    assert after[1]["mega_staged"] == before[1]["mega_staged"]
    pipe = build_pipeline(cfg, "fused1", precision=tier)
    for s, out in zip(scenes, outs):
        assert np.array_equal(out, pipe.run(s).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("fft_impl", ["matmul", "stockham"])
@pytest.mark.parametrize("n,p,kernel", [(128, 2, "mega_resident"),
                                        (256, 8, "mega_resident"),
                                        (256, 2, "mega_staged"),
                                        (1024, 2, "mega_staged")])
def test_cuda_lowered_fused1_equals_fused3(cuda_device, n, p, kernel,
                                           fft_impl):
    """fused1 lowered onto p slabs of one card (a mesh repeating it): one
    megakernel launch per slab per phase group — resident where a slab
    fits one block (16 x 128 ... 32 x 256), staged beyond (128 x 256 at
    256^2 / 2) — equal to the local fused3 and fused1 bit for bit;
    corner2 is fused3's three launches per slab, equal too."""
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.distributed import build_corner2, make_sar_mesh
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(n)
    raw = simulate(cfg, paper_targets(cfg))
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_sar_mesh(devices=[dev] * p)
    f3 = build_pipeline(cfg, "fused3", fft_impl=fft_impl).run(raw)
    run = build_pipeline(cfg, "fused1", fft_impl=fft_impl).lower_sharded(
        mesh)
    assert [u["residency"] for u in run.unit_info] == \
        [("vmem" if kernel == "mega_resident" else "staged")] * 3
    before = dict(ops.MEGA_LAUNCHES), ops.SPECTRAL_LAUNCHES
    img = run(raw)
    torch.cuda.synchronize()
    before[0][kernel] += run.dispatches_per_device * p
    assert (ops.MEGA_LAUNCHES, ops.SPECTRAL_LAUNCHES) == before
    assert torch.equal(img, f3)
    before = ops.SPECTRAL_LAUNCHES
    c2 = build_corner2(cfg, mesh, fft_impl=fft_impl)(raw)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 3 * p
    assert torch.equal(c2, f3)


@pytest.mark.gpu
@pytest.mark.parametrize("n,fft_impl", [(128, "matmul"), (128, "stockham"),
                                        (1024, "stockham")])
def test_cuda_lowered_bs16_equals_local_bs16(cuda_device, n, fft_impl):
    """bs16 on 2 slabs of one card: the carried exponents all-gathered
    across the turns give the local megakernel's image bit for bit (the
    matmul route at 128^2 alone: larger scenes overflow f16's range in
    its compressed range lines, in the plain version too)."""
    from repro_torch.core.sar import build_pipeline, paper_targets, simulate
    from repro_torch.core.sar.distributed import make_sar_mesh
    from repro_torch.core.sar.geometry import test_scene
    cfg = test_scene(n)
    raw = simulate(cfg, paper_targets(cfg))
    dev = torch.device("cuda", torch.cuda.current_device())
    pipe = build_pipeline(cfg, "fused1", precision="bs16", fft_impl=fft_impl)
    img = pipe.lower_sharded(make_sar_mesh(devices=[dev] * 2))(raw)
    assert torch.isfinite(img).all()
    assert torch.equal(img, pipe.run(raw))


# ---- core.fusion, the FFTConvMixer and the LM serving path -----------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 4096, 8192])
def test_cuda_fft_conv_matches_plain(cuda_device, n):
    from repro_torch.core import fft_conv
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    x = torch.randn((12, n), generator=gen, device=cuda_device)
    k = torch.fft.fft(torch.randn(n, generator=gen, device=cuda_device))
    kr, ki = k.real.contiguous(), k.imag.contiguous()
    before = ops.SPECTRAL_LAUNCHES
    got = fft_conv(x, kr, ki)
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    want = ops.spectral_op_plain(x, torch.zeros_like(x), hr=kr, hi=ki,
                                 filter_mode="shared")[0]
    assert_close([got], [want])
    assert_close([got], [fft_conv(x, kr, ki, backend="torch")])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [64, 2048])
def test_cuda_fftconv_forward_matches_plain(cuda_device, s):
    """The mixer's (B*D, 2S) lines in one launch, within 2e-4 of its plain
    version and of the torch.fft reference; the backward through the
    oracle's VJP launches nothing."""
    from repro_torch.models import fftconv
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(s)
    mixer = fftconv.init_fftconv(gen, 64, s)
    x = torch.randn((2, s, 64), generator=gen, device=cuda_device,
                    requires_grad=True)
    before = ops.SPECTRAL_LAUNCHES
    y = mixer(x)
    (y ** 2).sum().backward()
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 1
    with torch.no_grad():
        assert_close([y], [fftconv.fftconv_forward(mixer, x, "plain")])
        assert_close([y], [fftconv.fftconv_reference(mixer, x)])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b",
                                  "llama4-scout-17b-a16e", "whisper-tiny"])
def test_cuda_generate_matches_cpu(cuda_device, arch):
    """A smoke config served on the card: the same greedy tokens as on the
    CPU with the same weights, the logits within 1e-4 x max|want|, and no
    spectral launch."""
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    torch.set_float32_matmul_precision("highest")
    cfg = registry.smoke(arch)
    card = Model(cfg, device=cuda_device)
    card.init(torch.Generator(device=cuda_device).manual_seed(0))
    host = Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(1))
    before = ops.SPECTRAL_LAUNCHES
    got = generate(card, prompts, 8, 32)
    assert ops.SPECTRAL_LAUNCHES == before
    assert torch.equal(got.cpu(), generate(host, prompts, 8, 32))
    batch = {"tokens": prompts}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((2, cfg.encoder.n_frames, cfg.d_model))
    _, want = host.prefill(batch, 32)
    _, logits = card.prefill(batch, 32)
    assert_close([logits.cpu()], [want], tol=1e-4)


@pytest.mark.gpu
def test_cuda_token_stream_equals_cpu(cuda_device):
    """The stream draws on a CPU generator and moves the batch: the card
    and the CPU see the same batches."""
    from repro_torch.data import DataConfig, TokenStream
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=2)
    for step in (0, 7):
        got = TokenStream(cfg, cuda_device).batch(step)
        want = TokenStream(cfg, "cpu").batch(step)
        for k in want:
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), want[k])


def smoke_pair(arch, cuda_device, **changes):
    """A smoke model on the card and the same weights on the CPU, and a
    batch with labels drawn apart from the tokens."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import Model
    cfg = dataclasses.replace(registry.smoke(arch), remat=True, **changes)
    card = Model(cfg, device=cuda_device)
    card.init(torch.Generator(device=cuda_device).manual_seed(0))
    host = Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=gen)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((2, cfg.encoder.n_frames,
                                       cfg.d_model), generator=gen)
    return card, host, batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "whisper-tiny"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """One ``build_train_step`` step of a smoke config at f32, remat on:
    the loss and every parameter's gradient within 1e-4 x max|want| of
    the CPU's, no spectral launch."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    torch.set_float32_matmul_precision("highest")
    card, host, batch = smoke_pair(arch, cuda_device)
    grads = []
    for model in (card, host):
        model.zero_grad(set_to_none=True)
        model.loss({k: v.to(model.device) for k, v in batch.items()}
                   ).backward()
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert_close(list(grads[0].values()), list(grads[1].values()), tol=1e-4)
    before = ops.SPECTRAL_LAUNCHES
    stats = []
    for model in (card, host):
        step = steps.build_train_step(model)
        _, s = step(adamw.init(dict(model.named_parameters())),
                    {k: v.to(model.device) for k, v in batch.items()})
        stats.append(s)
    assert ops.SPECTRAL_LAUNCHES == before
    for k in ("loss", "grad_norm"):
        assert_close([stats[0][k].cpu()], [stats[1][k]], tol=1e-4)


@pytest.mark.gpu
def test_cuda_bf16_grads_match_cpu(cuda_device):
    """stablelm's smoke config at bf16: on the card the logits go through
    ``torch.mm(..., out_dtype=float32)`` and its gradient through
    ``_MatmulF32``; on the CPU through widened operands. Every parameter
    gets a finite gradient, within the CPU tests' bf16 bar (2e-2 x
    max|want|) of the CPU's."""
    card, host, batch = smoke_pair("stablelm-1.6b", cuda_device,
                                   dtype="bfloat16")
    grads = []
    for model in (card, host):
        model.loss({k: v.to(model.device) for k, v in batch.items()}
                   ).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads[0].values())
    assert_close([g.cpu() for g in grads[0].values()],
                 list(grads[1].values()), tol=2e-2)


@pytest.mark.gpu
def test_cuda_matmul_f32_gradient(cuda_device):
    """``_MatmulF32``'s backward: the cotangent at the operands' bf16,
    products and sums in f32, each gradient cast to bf16 — against the
    same recipe through widened operands (1e-2: bf16 rounds the outputs,
    the sums run in another order)."""
    from repro_torch.models.layers import matmul_f32
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn((96, 64), generator=gen, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    b = torch.randn((64, 200), generator=gen, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((96, 200), generator=gen, device=cuda_device)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32
    assert_close([out], [a.float() @ b.float()], tol=1e-5)
    out.backward(g)
    g16 = g.to(torch.bfloat16).float()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert_close([a.grad.float(), b.grad.float()],
                 [(g16 @ b.float().T).to(torch.bfloat16).float(),
                  (a.float().T @ g16).to(torch.bfloat16).float()], tol=1e-2)


@pytest.mark.gpu
def test_cuda_sharded_step_on_slabs_of_the_card(cuda_device):
    """A (2, 2) mesh of slabs of the card: the FFTConvMixer's sharded
    gradients launch the spectral kernel once a data position and equal
    the single-device kernel step's within 1e-5 x max|want|; an LM's
    sharded gradients (minitron smoke, f32) likewise."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import Model, fftconv
    torch.set_float32_matmul_precision("highest")
    mesh = lm.make_host_mesh(2, [cuda_device] * 4)
    rules = lm.activation_rules(mesh)

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    gen = torch.Generator(device=cuda_device).manual_seed(25)
    mixer = fftconv.init_fftconv(gen, 64, 256)
    data = {"x": torch.randn((4, 256, 64), generator=gen,
                             device=cuda_device),
            "y": torch.randn((4, 256, 64), generator=gen,
                             device=cuda_device)}
    values = {n: p.detach() for n, p in mixer.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, None, mesh, rules))

    def share(local, leaves, denom):
        y = fftconv.fftconv_forward(leaves, local["x"])
        return ((y - local["y"]) ** 2).sum() / denom

    before = ops.SPECTRAL_LAUNCHES
    loss, grads = steps.sharded_value_and_grad(
        share, params, data, mesh, rules,
        torch.tensor(float(data["x"].numel())))
    torch.cuda.synchronize()
    assert ops.SPECTRAL_LAUNCHES == before + 2
    want_loss = torch.mean((mixer(data["x"]) - data["y"]) ** 2)
    want = torch.autograd.grad(want_loss, list(mixer.parameters()))
    assert rel(loss, want_loss.detach()) <= 1e-5
    for (n, _), w in zip(mixer.named_parameters(), want):
        assert rel(grads[n].gather(), w) <= 1e-5, n

    cfg = registry.smoke("minitron-4b", seq=32)
    model = Model(cfg, device=cuda_device)
    model.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(cuda_device),
             "labels": tokens.roll(1, 1).to(cuda_device)}
    single = model.loss(batch)
    single.backward()
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    loss, grads = steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                          batch, mesh, rules)
    assert rel(loss, single.detach()) <= 1e-5
    for n, p in model.named_parameters():
        assert rel(grads[n].gather(), p.grad) <= 1e-5, n


@pytest.mark.gpu
def test_cuda_sharded_moe_remat_groups_spanning_positions(cuda_device):
    """granite smoke at f32 with every layer rematerialised, on a (4, 1)
    mesh of slabs of the card, routing groups of 96 tokens over positions
    of 64: the recomputation, which autograd runs on its own thread for
    the card, routes the forward's groups, and the gradients equal one
    device's within 1e-5 x max|want|."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import Model
    torch.set_float32_matmul_precision("highest")
    cfg = registry.smoke("granite-moe-3b-a800m", seq=32)
    cfg = dataclasses.replace(cfg, remat=True, moe=dataclasses.replace(
        cfg.moe, group_size=96, capacity_factor=1.0))
    mesh = lm.make_host_mesh(1, [cuda_device] * 4)
    rules = lm.activation_rules(mesh)
    model = Model(cfg, device=cuda_device)
    model.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (8, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens.to(cuda_device),
             "labels": tokens.roll(1, 1).to(cuda_device)}
    single = model.loss(batch)
    single.backward()
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    loss, grads = steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                          batch, mesh, rules)

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max().clamp(min=1e-30))

    assert rel(loss, single.detach()) <= 1e-5
    for n, p in model.named_parameters():
        assert rel(grads[n].gather(), p.grad) <= 1e-5, n


@pytest.mark.gpu
def test_cuda_bf16_prefill_rows_round_as_the_sharded_layout(cuda_device):
    """stablelm-1.6b at full width, bf16, on one device: a batch of 4
    prompts' prefill logits against the same 4 prompts one at a time,
    which is what each data position of a (4, 1) mesh runs. The gap is
    the size of the sharded prefill's own (within 2x): a 4-row and a
    1-row bf16 product round apart, and the sharded layout adds nothing."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import Model
    cfg = registry.get("stablelm-1.6b")
    assert cfg.dtype == "bfloat16"
    model = Model(cfg, device=cuda_device)
    model.init(torch.Generator(device=cuda_device).manual_seed(27))
    prompts = torch.randint(0, cfg.vocab_size, (4, 32),
                            generator=torch.Generator().manual_seed(27)
                            ).to(cuda_device)

    def rel(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    with torch.no_grad(), model.compute_cast():
        _, batch = model.prefill({"tokens": prompts}, 48)
        rows = torch.cat([model.prefill({"tokens": prompts[i:i + 1]}, 48)[1]
                          for i in range(4)])
    mesh = lm.make_host_mesh(1, [cuda_device] * 4)
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    _, sharded = steps.build_prefill(model, 48, mesh, rules, params)(
        {"tokens": prompts})
    one, cut = rel(rows, batch), rel(sharded, batch)
    assert cut > 0 and cut / 2 <= one <= 2 * cut, (one, cut)
