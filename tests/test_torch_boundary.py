"""The import boundary of the port: tenzing_tpu_torch and chip_smoke.py import
neither JAX nor any tenzing_tpu module, and the port's smoke driver leaves
JAX unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tenzing_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tenzing_tpu"), (path, mod)


def test_smoke_driver_leaves_jax_unloaded():
    code = (
        "import sys, json\n"
        "from tenzing_tpu_torch.bench.driver import DriverRequest, run\n"
        "r = run(DriverRequest(smoke=True, mcts_iters=2, iters=3, search_iters=2),"
        " device='cpu')\n"
        "assert r.verdict['verified'] is True, r.verdict\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
