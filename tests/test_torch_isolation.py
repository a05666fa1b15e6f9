"""The PyTorch port stands alone: no module of ``multimodal_moe_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``flax``, ``optax``, ``orbax`` or
``multimodal_moe_tpu``; the training, evaluation, data, ingestion and
serving modules and the CLIs are among those imported. No module imports
``sklearn`` (the card's host lacks it: the splits are the port's own numpy),
and none imports tqdm, nbformat or nbclient at module level (they are
optional; ``build_qa_notebooks`` imports the last two when it builds). The data modules
import pandas, pyarrow and PIL only inside the functions that use them, so
importing the port needs none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "multimodal_moe_tpu", "sklearn")
OPTIONAL = ("tqdm", "nbformat", "nbclient")   # imported inside the functions that use them
# Modules that must be among those the child imports (the training, the
# evaluation, the data and the serving modules, the CLIs).
REQUIRED = ("multimodal_moe_torch.losses.hungarian", "multimodal_moe_torch.ops.assignment",
            "multimodal_moe_torch.ops.augment", "multimodal_moe_torch.train.state",
            "multimodal_moe_torch.train.detection", "multimodal_moe_torch.train.evaluator",
            "multimodal_moe_torch.ops.coco_map", "multimodal_moe_torch.ops.preprocess",
            "multimodal_moe_torch.loading", "multimodal_moe_torch.train.artifacts",
            "multimodal_moe_torch.utils.profiler", "multimodal_moe_torch.quant",
            "multimodal_moe_torch.ops.int8_conv", "multimodal_moe_torch.data.solar",
            "multimodal_moe_torch.data.index", "multimodal_moe_torch.data.exports",
            "multimodal_moe_torch.data.native_decode", "multimodal_moe_torch.data.pipeline",
            "multimodal_moe_torch.data.resident", "multimodal_moe_torch.server",
            "multimodal_moe_torch.cli.serve_detector", "multimodal_moe_torch.cli.predict_detector",
            "multimodal_moe_torch.paths", "multimodal_moe_torch.data.yolo_layout",
            "multimodal_moe_torch.cli.train_yolo", "multimodal_moe_torch.cli.train_moe",
            "multimodal_moe_torch.cli.train_rtdetr", "multimodal_moe_torch.cli.eval_detector",
            "multimodal_moe_torch.cli.quantize_yolo",
            "multimodal_moe_torch.cli.train_vision_baseline",
            "multimodal_moe_torch.cli.analyze_moe_routing",
            "multimodal_moe_torch.data.bboxes", "multimodal_moe_torch.data.splits",
            "multimodal_moe_torch.data.indexer", "multimodal_moe_torch.data.qa",
            "multimodal_moe_torch.data.synthetic",
            "multimodal_moe_torch.cli.build_zod_index", "multimodal_moe_torch.cli.add_bboxes",
            "multimodal_moe_torch.cli.add_solar_context_bins",
            "multimodal_moe_torch.cli.create_splits",
            "multimodal_moe_torch.cli.export_yolo_dataset",
            "multimodal_moe_torch.cli.export_coco_dataset",
            "multimodal_moe_torch.cli.analyze_index_qa",
            "multimodal_moe_torch.cli.analyze_context_frequencies",
            "multimodal_moe_torch.cli.build_synth_corpus",
            "multimodal_moe_torch.cli.load_test_server",
            "multimodal_moe_torch.cli.sanity_dataloader",
            "multimodal_moe_torch.cli.report_detector_benchmarks",
            "multimodal_moe_torch.cli.vis_boxes", "multimodal_moe_torch.cli.print_paths",
            "multimodal_moe_torch.cli.build_qa_notebooks")

_CHILD = """
import importlib, pkgutil, sys
import multimodal_moe_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its main() runs only as a script)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})
lazy = sorted(m for m in ("pandas", "pyarrow", "PIL") if m in sys.modules)
print(" ".join(names))
print("lazy:" + ",".join(lazy))
print(len(names))
assert not bad, bad
"""


@pytest.fixture(scope="module")
def child():
    """One child that imports every module of the port and ``chip_smoke``."""
    code = _CHILD.replace("{forbidden}", repr(set(FORBIDDEN)))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_import_pulls_in_no_jax(child):
    proc = child
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 10  # every module was imported
    assert set(REQUIRED) <= set(proc.stdout.split())


def test_import_pulls_in_no_table_or_image_library(child):
    """pandas, pyarrow and PIL are present here but not imported by the
    import of every module (the card's host may lack them)."""
    proc = child
    assert proc.returncode == 0, proc.stderr
    import importlib.util

    assert all(importlib.util.find_spec(m) for m in ("pandas", "pyarrow", "PIL"))
    assert proc.stdout.split()[-2] == "lazy:", proc.stdout.split()[-2]   # none of them


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


def test_optional_packages_load_lazily():
    """No import of tqdm, nbformat or nbclient stands at module level
    (torch itself loads tqdm, so ``sys.modules`` cannot show it)."""
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        nested = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        for node in ast.walk(tree):
            if id(node) in nested:
                continue
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & set(OPTIONAL), f"{path}:{node.lineno} imports {roots}"
