"""The port's LM training path against the live JAX reference, on the
CPU: the MoE architectures, at the bars of
tests/test_torch_train_dense.py (whose helpers this uses); granite at a
capacity that drops tokens, on both dispatches (the aux loss's gradient
through the router's softmax; a dropped choice takes no expert
gradient); and gradient accumulation against the reference's own
``accum_steps=2`` (the microbatches form other groups, so other drops:
never against ``accum_steps=1``):

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_moe.py
"""
import pytest

from test_torch_train_dense import check_grads, check_train_step

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
GRANITE = "granite-moe-3b-a800m"


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def dropping(dispatch):
    """granite's smoke MoE at capacity_factor 1.0, 16 tokens a group:
    each expert keeps 8 of a group's 32 choices, so tokens drop
    (tests/test_torch_models_moe.py counts them)."""
    return (("capacity_factor", 1.0), ("group_size", 16),
            ("dispatch", dispatch))


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_dropping_capacity_train_step_matches_reference(dispatch):
    check_grads(GRANITE, moe=dropping(dispatch))
    check_train_step(GRANITE, moe=dropping(dispatch))


def test_accum_steps_2_matches_reference():
    check_train_step(GRANITE, accum=2, moe=dropping("gather"))
