"""The port's FFTConvMixer (``models/fftconv.py``) against the live
reference on the CPU, with the reference's ``init_fftconv`` parameters
carried across by ``models.convert.params_from_reference``:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fftconv.py

``fftconv_forward`` on both of its backends (``kernel``: the spectral op,
the plain version on a CPU tensor; ``plain``) and ``fftconv_reference`` within 2e-4 x max|want| of the
reference's (the reference's own bar, tests/test_fftconv.py), the
causality check of tests/test_fftconv.py, and the gradients of sum(y^2)
through the autograd.Function against ``jax.grad`` of the reference's
custom VJP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import fftconv as ref_fc
from repro_torch.kernels import ops
from repro_torch.models import fftconv
from repro_torch.models.convert import params_from_reference

TOL = 2e-4
# the gradients: the backward is the oracle's VJP on both sides, so they
# differ by float32 rounding alone (measured ~3e-7 x max|want|)
GRAD_TOL = 1e-5


def pair(seed, d, s):
    p = ref_fc.init_fftconv(jax.random.PRNGKey(seed), d, s)
    m = fftconv.FFTConvMixer(d, s, "cpu")
    m.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    return p, m


def rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_fused_matches_reference(backend):
    b, s, d = 2, 64, 16
    p, m = pair(0, d, s)
    x = np.random.default_rng(0).standard_normal((b, s, d)).astype(
        np.float32)
    want = ref_fc.fftconv_forward(p, jnp.asarray(x))
    with torch.no_grad():
        got = fftconv.fftconv_forward(m, torch.from_numpy(x), backend)
    assert rel(got, want) <= TOL
    assert rel(got, ref_fc.fftconv_reference(p, jnp.asarray(x))) <= TOL


def test_reference_oracle_matches_reference():
    b, s, d = 2, 64, 16
    p, m = pair(0, d, s)
    x = np.random.default_rng(0).standard_normal((b, s, d)).astype(
        np.float32)
    with torch.no_grad():
        got = fftconv.fftconv_reference(m, torch.from_numpy(x))
        mod = m(torch.from_numpy(x))
    assert rel(got, ref_fc.fftconv_reference(p, jnp.asarray(x))) <= TOL
    assert rel(mod, got.numpy()) <= TOL


def test_causality():
    """Changing x at position t only affects outputs at positions >= t."""
    b, s, d = 1, 32, 8
    _, m = pair(1, d, s)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    t = 20
    x2 = x.clone()
    x2[:, t] += 1.0
    with torch.no_grad():
        for fn in (fftconv.fftconv_reference, fftconv.fftconv_forward):
            y1, y2 = fn(m, x).numpy(), fn(m, x2).numpy()
            assert np.abs(y2[:, :t] - y1[:, :t]).max() < 1e-5
            assert np.abs(y2[:, t:] - y1[:, t:]).max() > 1e-4


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_gradients_match_jax_grad(backend):
    b, s, d = 2, 32, 8
    p, m = pair(2, d, s)
    x = np.random.default_rng(2).standard_normal((b, s, d)).astype(
        np.float32)
    want_p, want_x = jax.grad(lambda p, x: jnp.sum(
        ref_fc.fftconv_forward(p, x) ** 2), argnums=(0, 1))(
            p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = (fftconv.fftconv_forward(m, xt, backend) ** 2).sum()
    loss.backward()
    for name, param in m.named_parameters():
        assert rel(param.grad, want_p[name]) <= GRAD_TOL, name
    assert rel(xt.grad, want_x) <= GRAD_TOL


def test_one_spectral_op_call_a_forward(monkeypatch):
    """The mixer's lines go through ``ops.spectral_op`` once a forward,
    filter mode ``full`` on rows (one launch on a CUDA tensor), and not
    again in the backward (the oracle's VJP)."""
    calls = []
    real = ops.spectral_op

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "spectral_op", spy)
    _, m = pair(3, 8, 32)
    x = torch.randn(2, 32, 8, requires_grad=True)
    (m(x) ** 2).sum().backward()
    assert len(calls) == 1
    assert calls[0]["filter_mode"] == "full" and calls[0]["axis"] == 1


def test_init_fftconv_draws_from_the_generator():
    gen = torch.Generator()
    gen.manual_seed(0)
    a = fftconv.init_fftconv(gen, 8, 16)
    gen.manual_seed(0)
    b = fftconv.init_fftconv(gen, 8, 16)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.kernel.detach().abs().max()) <= 2 * 0.02
    np.testing.assert_allclose(a.decay.detach().numpy(),
                               np.linspace(1.0, 6.0, 8), rtol=1e-6)
