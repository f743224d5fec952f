"""The port's LM serving path against the live JAX reference, on the CPU:
the MoE architectures, at the bars of tests/test_torch_models_dense.py
(whose helpers this uses), and the MoE FFN at a capacity that drops
tokens, on both dispatches:

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_moe.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference

from test_torch_models_dense import (
    TOL, check_decode_equals_forward, check_forward, check_generate,
    check_prefill_decode, rel)

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]


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


def moe_case(dispatch, arch="granite-moe-3b-a800m", capacity_factor=1.0,
             group_size=16, d=64, f=128, tokens=(2, 32)):
    """granite's smoke MoE (8 experts, top 2) at a capacity that drops
    tokens, grouped 16 tokens a group: the reference's parameters and
    output, and the port's."""
    ref_cfg = dataclasses.replace(
        ref_registry.smoke(arch).moe, capacity_factor=capacity_factor,
        group_size=group_size, dispatch=dispatch)
    cfg = dataclasses.replace(
        registry.smoke(arch).moe, capacity_factor=capacity_factor,
        group_size=group_size, dispatch=dispatch)
    p = ref_moe.init_moe(jax.random.PRNGKey(5), d, f, ref_cfg)
    m = moe.MoE(d, f, cfg, "cpu")
    m.load_state_dict(params_from_reference(jax.tree.map(np.asarray, p)))
    x = np.random.default_rng(6).standard_normal((*tokens, d)).astype(
        np.float32)
    want = ref_moe.moe_ffn(p, jnp.asarray(x), ref_cfg)
    with torch.no_grad():
        got = moe.moe_ffn(m, torch.from_numpy(x), cfg)
    return m, cfg, x, got, want


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_capacity_drops_match_reference(dispatch):
    """capacity_factor 1.0: each expert keeps 8 of a group's 32 choices
    (16 tokens x top 2 / 8 experts, rounded up to 8), so tokens drop. A
    choice dropped on one side and kept on the other moves that token's
    output by a whole expert's contribution; the outputs agree at 1e-4
    and the aux loss (which counts the kept choices) to 1e-6."""
    m, cfg, x, (y, aux), (want_y, want_aux) = moe_case(dispatch)
    assert rel(y, want_y) <= TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    # the drops this run makes, from the port's routing
    xg = torch.from_numpy(x).reshape(-1, cfg.group_size, x.shape[-1])
    probs = torch.softmax(xg @ m.router, dim=-1)
    c = moe._capacity(cfg.group_size, cfg)
    _, _, _, within, _ = moe.route(probs, cfg, c)
    kept = torch.stack(within, -1)                    # (G, Sg, K)
    assert c == 8 and int((kept == 0).sum()) > 0
    # a token whose every choice dropped has a zero row on both sides
    all_dropped = (kept.sum(-1) == 0).reshape(-1)
    want_rows = np.abs(np.asarray(want_y).reshape(-1, x.shape[-1])).sum(-1)
    got_rows = y.reshape(-1, x.shape[-1]).abs().sum(-1)
    np.testing.assert_array_equal(all_dropped.numpy(), want_rows == 0)
    assert torch.equal(all_dropped, got_rows == 0)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_dropless_matches_reference(dispatch):
    """The smoke capacity (capacity_factor = n_experts): nothing drops."""
    _, _, _, (y, aux), (want_y, want_aux) = moe_case(
        dispatch, capacity_factor=8.0)
    assert rel(y, want_y) <= TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


def test_moe_shared_expert_matches_reference():
    """llama4's smoke MoE: top 1 of 8 and the always-on shared expert,
    with a capacity that drops."""
    _, _, _, (y, _), (want_y, _) = moe_case(
        "gather", arch="llama4-scout-17b-a16e")
    assert rel(y, want_y) <= TOL


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[[0.25, 0.25, 0.4, 0.1]]])
    vals, idx = moe.top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[[2, 0, 1]]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
