"""The port's LM training path against the live JAX reference, on the
CPU: the recurrent mixers (recurrentgemma's RG-LRU, falcon-mamba's
Mamba), at the bars of tests/test_torch_train_dense.py (whose helpers
this uses), and the scans' gradients past one chunk:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_mixers.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as ref_rec
from repro_torch.models import recurrent as rec

from test_torch_models_dense import TOL
from test_torch_train_dense import check_grads, check_train_step, close

ARCHS = ["recurrentgemma-9b", "falcon-mamba-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("s", [64, 96])
def test_chunked_scan_grads_match_reference(s):
    """The log-depth scan over chunks of 32 carrying the state (s = 64:
    two chunks; 96: three): the gradients of a weighted sum of every h_t
    with respect to a, b and h0, against ``jax.grad`` through the
    reference's scan."""
    r = np.random.default_rng(s)
    a = r.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = r.standard_normal((2, s, 8)).astype(np.float32)
    h0 = r.standard_normal((2, 8)).astype(np.float32)
    w = r.standard_normal((2, s, 8)).astype(np.float32)

    def ref_loss(a, b, h0):
        h, last = ref_rec.chunked_linear_scan(a, b, 32, h0)
        return jnp.sum(h * w) + jnp.sum(last)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ta, tb, th = (torch.from_numpy(v).requires_grad_() for v in (a, b, h0))
    h, last = rec.chunked_linear_scan(ta, tb, 32, th)
    (torch.sum(h * torch.from_numpy(w)) + torch.sum(last)).backward()
    for got, wnt in zip((ta.grad, tb.grad, th.grad), want):
        assert close(got, np.asarray(wnt), TOL)
