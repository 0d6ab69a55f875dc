"""The import boundary of the PyTorch port: no file of
``clearml_serving_tpu_torch/``, and not ``chip_smoke.py``, imports ``jax``,
``jaxlib``, ``flax`` or anything of ``clearml_serving_tpu``. An AST scan of
every import statement, plus a fresh interpreter that imports every module of
the port with those packages blocked (so nothing reaches them indirectly)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "clearml_serving_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "clearml_serving_tpu")


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", "")) in ("import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, "{} imports {}".format(path.relative_to(ROOT), bad)


def test_port_imports_with_jax_and_the_reference_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for name in {!r}: sys.modules[name] = None\n"
        "import importlib\n"
        "for m in {!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    ).format(FORBIDDEN, modules)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
