"""The CUDA kernels' long-line passes on the CPU through
``scripts/mock_cuda`` (g++ against a mock of the CUDA runtime: a thread a
CUDA thread, barriers, exact tensor-core products): ``spectral.cu`` is
built as the card builds it and run with the tile passes' asynchronous
ring and without it, its copies made as issued and as their wait retires
them. The three runs must agree bit for bit and stay within 1e-5 of the
plain version (relative to its largest magnitude), and the ring's runs
must make copies. This keeps the mock building against today's kernels.

Small shapes (the mock runs 512 OS threads a block): a matmul-route
three-factor split on rows (its digit's and its tail's tiles take the
ring, its DFT matrices before the slots) and Stockham rows past a
whole-line tile.
"""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "scripts", "mock_cuda", "run.py")
CASES = ('[(2048, 1, "shared", True, False, "matmul", "f32", False, '
         '(8, 16, 16), 3), (32768, 1, "full", True, True, "stockham", '
         '"f32", False, None, 1)]')


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="the mock builds the kernels with g++")
def test_mock_long_passes_ring_matches_loads_and_plain(tmp_path):
    build = subprocess.run([sys.executable, RUN, "build", ROOT,
                            str(tmp_path), "spectral"],
                           capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stdout[-4000:] + build.stderr[-4000:]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, RUN, "check", ROOT, str(tmp_path),
                          CASES, "1e-5", "[0, 1]"], capture_output=True,
                         text=True, timeout=900, cwd=str(tmp_path), env=env)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert "failing cases: 0" in run.stdout
