"""The port's LM serving path against the live JAX reference, on the CPU:
the sliding-window architecture (gemma3's 5:1 local:global pattern) and
the encoder-decoder (whisper: cross-attention, the sinusoid added at the
runtime position), at the bars of tests/test_torch_models_dense.py (whose
helpers this uses); decoding past the window; one bf16 case:

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_local.py
"""
import numpy as np
import pytest
import torch

from repro_torch.models.layers import logits_last

from test_torch_models_dense import (
    S, check_decode_equals_forward, check_forward, check_generate,
    check_prefill_decode, on_torch, port, reference)

ARCHS = ["gemma3-12b", "whisper-tiny"]


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


def test_long_decode_ring_cache():
    """Decoding past the sliding window (16 positions in the smoke config)
    keeps the ring cache's size and matches the full forward: the prefill
    fills the ring past its size (rolled by (s - w) mod w), then each step
    overwrites the oldest slot."""
    ref = reference("gemma3-12b")
    model = port("gemma3-12b", ref)
    toks = on_torch(ref["batch"])["tokens"]
    t = S - 8
    cache, _ = model.prefill({"tokens": toks[:, :t]}, S)
    window = model.cfg.window
    sizes = {c["k"].shape[1] for c, kind in zip(cache["layers"],
                                                model.cfg.layer_kinds)
             if kind == "local"}
    assert sizes == {window} and t > window
    for i in range(4):
        logits, cache = model.decode_step(cache, toks[:, t + i:t + i + 1])
    with torch.no_grad():
        x, _, _ = model.forward({"tokens": toks[:, :t + 4]}, train=False)
        want = logits_last(x[:, t + 3], model.embed.table)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-3)


# bf16 compute: every matmul's output rounds to bf16 on both sides, in
# different orders of accumulation (XLA's and torch's CPU kernels), and
# the roundings compound over the layers; measured 7.9e-3 (hidden) and
# 3.2e-3 (logits) x max|want| on this config
BF16_TOL = 2e-2


def test_bf16_stablelm_matches_reference():
    check_forward("stablelm-1.6b", tol=BF16_TOL, dtype="bfloat16")
    check_prefill_decode("stablelm-1.6b", tol=BF16_TOL, dtype="bfloat16")
