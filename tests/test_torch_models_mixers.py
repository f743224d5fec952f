"""The port's LM serving path against the live JAX reference, on the CPU:
the architectures with recurrent mixers (RG-LRU, Mamba), at the bars of
tests/test_torch_models_dense.py (whose helpers this uses), and the scans
past one chunk:

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_mixers.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as ref_rec
from repro.models.config import RGLRUConfig as RefRGLRU
from repro.models.config import SSMConfig as RefSSM
from repro_torch.models import recurrent as rec
from repro_torch.models.config import RGLRUConfig, SSMConfig
from repro_torch.models.convert import params_from_reference

from test_torch_models_dense import (
    TOL, check_decode_equals_forward, check_forward, check_generate,
    check_prefill_decode, rel)

ARCHS = ["recurrentgemma-9b", "falcon-mamba-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    check_decode_equals_forward(arch)


def carried(tree):
    return {k: v for k, v in params_from_reference(
        jax.tree.map(np.asarray, tree)).items()}


def mamba_pair(d=32):
    ref_cfg = RefSSM(state_dim=4, conv_width=4, expand=2)
    p = ref_rec.init_mamba(jax.random.PRNGKey(3), d, ref_cfg)
    cfg = SSMConfig(state_dim=4, conv_width=4, expand=2)
    m = rec.Mamba(d, cfg, "cpu")
    m.load_state_dict(carried(p))
    return p, ref_cfg, m, cfg


def rglru_pair(d=32):
    ref_cfg = RefRGLRU(conv_width=4, lru_width=32)
    p = ref_rec.init_rglru(jax.random.PRNGKey(4), d, ref_cfg)
    cfg = RGLRUConfig(conv_width=4, lru_width=32)
    m = rec.RGLRU(d, cfg, "cpu")
    m.load_state_dict(carried(p))
    return p, ref_cfg, m, cfg


@pytest.mark.parametrize("kind,s", [("mamba", 256), ("mamba", 384),
                                    ("rglru", 1024)])
def test_scan_past_one_chunk_matches_reference(kind, s):
    """Mamba (chunk 128) and RG-LRU (chunk 512) over sequences longer than
    a chunk, the state carried from chunk to chunk; the last state is the
    decode state: one step after it against the reference's step."""
    p, ref_cfg, m, cfg = (mamba_pair if kind == "mamba" else rglru_pair)()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    fwd, step = ((ref_rec.mamba_forward, ref_rec.mamba_step)
                 if kind == "mamba" else
                 (ref_rec.rglru_forward, ref_rec.rglru_step))
    pfwd, pstep = ((rec.mamba_forward, rec.mamba_step) if kind == "mamba"
                   else (rec.rglru_forward, rec.rglru_step))
    y, state = jax.jit(lambda p, x: fwd(p, x, ref_cfg))(p, jnp.asarray(x))
    y1, state1 = jax.jit(lambda p, x, st: step(p, x, ref_cfg, st))(
        p, jnp.asarray(x1), state)
    with torch.no_grad():
        gy, gstate = pfwd(m, torch.from_numpy(x), cfg)
        gy1, gstate1 = pstep(m, torch.from_numpy(x1), cfg, gstate)
    assert rel(gy, y) <= TOL and rel(gy1, y1) <= TOL
    for g, w in zip(gstate, state):
        assert rel(g, w) <= TOL
    for g, w in zip(gstate1, state1):
        assert rel(g, w) <= TOL


def test_chunked_scan_keeps_its_assertion():
    a = torch.rand(1, 768, 4)
    with pytest.raises(AssertionError):
        rec.chunked_linear_scan(a, a, 512, torch.zeros(1, 4))
    h, last = rec.chunked_linear_scan(a, a, 256, torch.zeros(1, 4))
    assert torch.equal(h[:, -1], last)


@pytest.mark.parametrize("s", [1, 2, 5, 64])
def test_linear_scan_matches_reference(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (3, s, 4)).astype(np.float32)
    b = rng.standard_normal((3, s, 4)).astype(np.float32)
    h0 = rng.standard_normal((3, 4)).astype(np.float32)
    want = ref_rec.linear_scan(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0))
    got = rec.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(h0))
    assert rel(got, want) <= TOL
