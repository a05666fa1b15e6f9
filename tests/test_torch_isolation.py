"""The PyTorch port stands alone: no module of ``multimodal_moe_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``flax`` or ``multimodal_moe_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "multimodal_moe_tpu")

_CHILD = """
import importlib, pkgutil, sys
import multimodal_moe_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its main() runs only as a script)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})
print(len(names))
assert not bad, bad
"""


def test_import_pulls_in_no_jax():
    code = _CHILD.replace("{forbidden}", repr(set(FORBIDDEN)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10  # every module was imported


def _sources():
    yield from sorted((REPO / "multimodal_moe_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"


def test_no_forbidden_import_statement():
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & set(FORBIDDEN), f"{path}:{node.lineno} imports {roots}"
