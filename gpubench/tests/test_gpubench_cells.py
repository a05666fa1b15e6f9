"""A cell, a configuration's cells and a metric are found by name: one
added as files only, in a copy of the benchmark, runs with no edit to the
harness. The command refuses to run without a card, and in a directory
that holds only the benchmark's own files."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_COPY = """
import json, sys, torch
sys.path.insert(0, {copy!r})
sys.path.insert(1, {root!r})
torch.set_num_threads(2)
from gpubench import run
assert run.ROOT == __import__("pathlib").Path({copy!r}) / "gpubench", run.ROOT
r, line = run.execute(["--workload", "yolo_s.tiny_offline", "--seed", "2147483700",
                       "--seconds", "0.2", "--trace", "1"], device=torch.device("cpu"))
print(json.dumps(line))
"""


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", copy / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".triton_cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((ROOT / "gpubench/cells/yolo_s.offline_b128.json").read_text())
    # A test fixture at a toy size, with limits of its own.
    cell.update(batch=2, pool_batches=2, img_h=64, img_w=128, check_images=2, profile_steps=2,
                pool=32, max_det=10, checks={"logit_err": 1.0, "box_err": 1.0})
    (copy / "gpubench/cells/yolo_s.tiny_offline.json").write_text(json.dumps(cell))
    (copy / "gpubench/metrics/steps_profiled.serve.py").write_text(
        "def read(run):\n    return run.layer.get('steps')\n")
    bench["workloads"].append(dict(bench["workloads"][-1], name="yolo_s.tiny_offline",
                                   traffic="tiny_offline"))
    bench["per_layer"].append({"name": "steps_profiled.serve", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "serving step", "moves": "serve_img_s",
                               "workloads": ["yolo_s.tiny_offline"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUN_COPY.format(copy=str(copy), root=str(ROOT))],
                         cwd=str(copy), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["steps_profiled.serve"]["value"] == 2
    assert list(line)[-1] == "checks"


def test_the_command_needs_a_card_and_the_port(tmp_path):
    """Here there is no card: the command fails and prints no result. In a
    directory with only BENCHMARK.json and gpubench/ it fails the same way."""
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                              "yolo_s.offline_b128", "--seed", "1", "--seconds", "1",
                              "--trace", "0"], cwd=str(cwd), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert not out.stdout.strip()


def test_benchmark_file_names_every_cell_config_and_metric_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = json.loads((ROOT / "gpubench/cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert (ROOT / "gpubench/drivers" / f"{cell['driver']}.py").is_file()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["per_layer"]:
        assert (ROOT / "gpubench/metrics" / f"{m['name']}.py").is_file()
