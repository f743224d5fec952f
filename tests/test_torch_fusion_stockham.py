"""``SpectralPipeline`` on the Stockham route against the live reference
(the matmul route and the rest of ``core.fusion`` are in
tests/test_torch_fusion.py, whose case this runs):

    PYTHONPATH=src python -m pytest -q tests/test_torch_fusion_stockham.py
"""
import pytest

from test_torch_fusion import DIRS, MODES, check_against_reference


@pytest.mark.parametrize("fwd,inv", DIRS, ids=["fwd", "inv", "fwd_inv"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axis", [1, 0], ids=["rows", "cols"])
def test_stockham_pipeline_matches_reference(axis, mode, fwd, inv):
    check_against_reference("stockham", axis, mode, fwd, inv)
