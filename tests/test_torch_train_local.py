"""The port's LM training path against the live JAX reference, on the
CPU: the sliding-window architecture (gemma3's 5:1 local:global
pattern) and the encoder-decoder (whisper: the encoder and the
cross-attention), at the bars of tests/test_torch_train_dense.py (whose
helpers this uses):

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_local.py
"""
import pytest

from test_torch_train_dense import check_grads, check_train_step

ARCHS = ["gemma3-12b", "whisper-tiny"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
