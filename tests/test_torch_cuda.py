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
    for kw in (dict(), dict(fft_impl="stockham")):
        with pytest.raises(ValueError, match="ROADMAP"):
            ops.fft_rows(*big, **kw)
    assert ops.SPECTRAL_LAUNCHES == before
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
