"""The hand-written CUDA spectral kernel against its plain PyTorch version,
on the card. Imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test here needs a CUDA card (marker ``gpu``) and skips without one:
the CUDA kernel has no CPU mode. Tolerance 2e-4 x max|want|, the
reference's own (tests/test_kernels.py).
"""
import pytest
import torch

from repro_torch.kernels import ops

TOL = 2e-4
MODES = ["none", "shared", "full", "outer", "shared_outer"]
DIRS = [(True, False), (False, True), (True, True), (False, False)]


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


def assert_close(got, want):
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= TOL * scale, (err, scale)


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


@pytest.mark.gpu
def test_cuda_kernel_unbatched_and_padded(cuda_device):
    x, filt = make_case(cuda_device, 3, "outer", 0, 256, 1, lines=21)
    kw = dict(axis=0, fwd=True, inv=True, filter_mode="outer", block=8)
    got = ops.spectral_op(x[0][0], x[1][0], **filt, **kw)
    assert got[0].shape == (256, 21)
    assert_close(got, ops.spectral_op_plain(x[0][0], x[1][0], **filt, **kw))


@pytest.mark.gpu
def test_cuda_kernel_refuses_and_never_falls_back(cuda_device):
    x, _ = make_case(cuda_device, 5, "none", 1, 64, 1, lines=4)
    before = ops.SPECTRAL_LAUNCHES
    for kw in (dict(precision="bf16"), dict(karatsuba=True),
               dict(fft_impl="stockham")):
        with pytest.raises(ValueError, match="ROADMAP"):
            ops.fft_rows(*x, **kw)
    big = make_case(cuda_device, 5, "none", 1, 8192, 1, lines=2)[0]
    with pytest.raises(ValueError, match="ROADMAP"):
        ops.fft_rows(*big)
    assert ops.SPECTRAL_LAUNCHES == before
