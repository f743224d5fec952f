"""Import hygiene of the port: ``src/repro_torch/`` and ``chip_smoke.py``
import neither JAX nor the JAX package ``repro``, and importing
``repro_torch`` leaves ``jax`` out of ``sys.modules``."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(SRC, "repro_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_files_exist():
    files = port_files()
    assert os.path.exists(files[0])
    assert any(f.endswith(os.path.join("kernels", "ops.py")) for f in files)


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    assert forbidden_imports(path) == []


def test_checker_catches_forbidden_imports(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import plan\n"
                 "from repro_torch.core import plan as ok\n")
    assert forbidden_imports(str(p)) == ["jax.numpy", "repro.core"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.sar, "
            "repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
