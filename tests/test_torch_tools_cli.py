"""The port's last tools against the JAX package's scripts on the CPU:
``load_test_server``, ``sanity_dataloader``, ``report_detector_benchmarks``,
``vis_boxes``, ``print_paths`` and ``build_qa_notebooks``.

* ``--help`` of each: the same options; the same defaults where the script
  has a ``parse_args``.
* ``print_paths`` (as children, under one environment whose registry holds
  a directory, a file and missing paths) and ``sanity_dataloader`` (in
  process, on the data tests' corpus): the same stdout.
* ``report_detector_benchmarks`` over one tree of eval run dirs (a run with
  a PR curve, one with metadata only, one whose metrics JSON is broken, one
  with nothing readable, an empty family): the three CSVs byte-equal, the
  same lines, the plots written by both; and where matplotlib cannot be
  imported, the CSVs and the line that the plots were skipped.
* ``vis_boxes`` on a parquet of drawn frames (a frame without its image,
  unclear flags missing or shorter than the boxes), with the pool of frames
  that have both kinds of pedestrian and with the fallback pool: the same
  picks and byte-equal JPEGs.
* ``load_test_server._make_jpeg``: byte-equal at the default 704x1248 and
  at 64x96 (the load test itself is ``tests/test_torch_load_test.py``).
* ``build_qa_notebooks --no-execute`` into a temporary directory: each
  cell's kind and source equal to JAX's with the package name substituted;
  JAX's two notebooks untouched. The two committed notebooks: the cells
  ``build_qa_notebooks`` makes, every code cell executed without an error.
"""

import builtins
import contextlib
import importlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from _torch_data import write_corpus

REPO = Path(__file__).resolve().parents[1]
CLIS = ("load_test_server", "sanity_dataloader", "report_detector_benchmarks", "vis_boxes",
        "print_paths", "build_qa_notebooks")
NO_PARSE_ARGS = ("print_paths", "build_qa_notebooks")   # the scripts parse inside main()
REQUIRED_ARGS = {"load_test_server": ["--weights", "w"]}


def port_cli(name: str):
    return importlib.import_module(f"multimodal_moe_torch.cli.{name}")


def jax_script(name: str):
    """``scripts/<name>.py`` as a module (its ``_common`` import needs
    ``scripts/`` on the path)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.fixture(autouse=True)
def no_xla_cache(monkeypatch):
    monkeypatch.setenv("MMOE_XLA_CACHE", "")


def stdout_of(run) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run()
    return out.getvalue()


def run_jax(name: str, args: list, monkeypatch) -> str:
    module = jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, args)])
    return stdout_of(module.main)


def run_port(name: str, args: list) -> str:
    return stdout_of(lambda: port_cli(name).main([str(a) for a in args]))


def help_text(run) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            run()
        except SystemExit as e:
            assert e.code in (0, None)
    return out.getvalue()


@pytest.mark.parametrize("name", CLIS)
def test_help_and_defaults_match(name, monkeypatch):
    module = jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--help"])
    ref = help_text(module.main)
    got = help_text(lambda: port_cli(name).main(["--help"]))
    options = lambda text: sorted(set(re.findall(r"(?<![\w/])--[a-z][a-z0-9-]*", text)))  # noqa: E731
    assert options(got) == options(ref)
    if name in NO_PARSE_ARGS:
        # print_paths takes no arguments: --help prints the registry, as JAX's
        assert (name == "print_paths") == ("usage:" not in ref)
        return
    extra = REQUIRED_ARGS.get(name, [])
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *extra])
    assert vars(port_cli(name).parse_args(extra)) == vars(module.parse_args())


def test_print_paths_prints_jax_lines(tmp_path):
    """Both registries under one environment: a directory, a file, and
    every other path missing."""
    outputs = tmp_path / "outputs"
    (outputs / "eval").mkdir(parents=True)
    (tmp_path / "frames.parquet").write_bytes(b"")
    env = {**os.environ, "MMOE_XLA_CACHE": "", "HOME": str(tmp_path / "home"),
           "OUTPUTS_DIR": str(outputs), "ZODMOE_FRAMES_PARQUET": str(tmp_path / "frames.parquet"),
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    runs = [subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
            for argv in ([sys.executable, str(REPO / "scripts" / "print_paths.py")],
                         [sys.executable, "-m", "multimodal_moe_torch.cli.print_paths"])]
    for proc in runs:
        assert proc.returncode == 0, proc.stderr
    want, got = (proc.stdout for proc in runs)
    assert got == want
    statuses = {line.split()[0]: line.split()[1] for line in got.splitlines()}
    assert statuses["EVAL_DIR"] == "dir" and statuses["ZODMOE_FRAMES_PARQUET"] == "file"
    assert statuses["RUNS_DIR"] == "missing" and len(statuses) == 18


def test_sanity_dataloader_prints_jax_lines(tmp_path, monkeypatch):
    corpus = write_corpus(tmp_path / "corpus", 7, seed=4)
    args = ["--parquet", corpus["parquet"], "--split-csv", corpus["train"], "--batch", 3]
    want = run_jax("sanity_dataloader", args, monkeypatch)
    got = run_port("sanity_dataloader", args)
    assert got == want
    assert got.startswith("dataset length: 7\n") and len(got.splitlines()) == 3


def _eval_tree(root: Path) -> Path:
    """Eval run dirs as ``cli/eval_detector.py`` leaves them, and the odd
    ones a report meets."""
    def write(path: Path, payload) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(payload if isinstance(payload, str) else json.dumps(payload))

    rng = np.random.default_rng(3)
    recall = np.linspace(0, 1, 11)
    metrics = {"map50": 0.61234, "map50_95": 0.4, "precision": 0.7, "recall": 0.55,
               "speed_preprocess_ms_per_img": 0.4, "speed_inference_ms_per_img": 11.45,
               "speed_postprocess_ms_per_img": 0.09, "speed_total_ms_per_img": 11.94,
               "fps_inference_only": 87.3, "fps_end_to_end": 83.75, "params_total": 9123456,
               "flops_g": 89.51, "n_images": 62,
               "curves_results": [
                   {"name": "Precision-Recall(B)", "x": recall.tolist(),
                    "y": np.sort(rng.random(11))[::-1].tolist()},
                   {"name": "F1-Confidence(B)", "x": recall.tolist(), "y": rng.random(11).tolist()}]}
    meta = {"model_variant": "s", "split": "test", "img_h": 704, "img_w": 1248, "seed": 0}
    write(root / "yolo" / "yolo_s" / "metrics.json", metrics)
    write(root / "yolo" / "yolo_s" / "run_metadata.json", meta)
    write(root / "yolo" / "yolo_s" / "train_summary.json", {"train_wall_time_s": 1234.5})
    write(root / "moe" / "moe_s" / "metrics.json",
          {**metrics, "map50": 0.65, "fps_end_to_end": 70.1, "curves_results": [
              {"name": "Precision-Recall(B)", "x": [0.0, 1.0], "y": [1.0, 0.2]}]})
    write(root / "moe" / "meta_only" / "run_metadata.json", {**meta, "model_variant": "moe-s"})
    write(root / "rtdetr" / "broken" / "metrics.json", '{"map50": 0.3,')
    write(root / "rtdetr" / "broken" / "run_metadata.json", {**meta, "model_variant": "r50vd"})
    write(root / "rtdetr" / "unreadable" / "metrics.json", "not json")
    (root / "rtdetr" / "empty_run").mkdir(parents=True)
    (root / "empty_family").mkdir()
    (root / "notes.txt").write_text("not a family")
    return root


CSVS = ("baseline_runs_aggregated.csv", "speed_vs_accuracy_table.csv",
        "precision_recall_operating_points.csv")


def test_report_writes_jax_csvs(tmp_path, monkeypatch):
    tree = _eval_tree(tmp_path / "eval")
    args = lambda out: ["--eval-dir", tree, "--out-dir", out]  # noqa: E731
    want = run_jax("report_detector_benchmarks", args(tmp_path / "jax"), monkeypatch)
    got = run_port("report_detector_benchmarks", args(tmp_path / "port"))
    assert got.replace(str(tmp_path / "port"), "OUT") == want.replace(str(tmp_path / "jax"), "OUT")
    for name in CSVS:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    rows = pd.read_csv(tmp_path / "port" / CSVS[0])
    assert list(zip(rows["family"], rows["run"])) == [
        ("moe", "meta_only"), ("moe", "moe_s"), ("rtdetr", "broken"), ("yolo", "yolo_s")]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert (tmp_path / "port" / "pr_curve_overlay.png").exists()


def test_report_without_matplotlib(tmp_path, monkeypatch):
    tree = _eval_tree(tmp_path / "eval")
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *a, **k)

    jax_module = jax_script("report_detector_benchmarks")
    with monkeypatch.context() as m:
        m.setattr(builtins, "__import__", no_matplotlib)
        m.setattr(sys, "argv", ["x.py", "--eval-dir", str(tree), "--out-dir", str(tmp_path / "jax")])
        want = stdout_of(jax_module.main)
        got = run_port("report_detector_benchmarks",
                       ["--eval-dir", tree, "--out-dir", tmp_path / "port"])
    assert got.splitlines()[-1] == want.splitlines()[-1] == "matplotlib unavailable; skipped plots"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(CSVS)
    for name in CSVS:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert run_port("report_detector_benchmarks",
                    ["--eval-dir", tmp_path / "port", "--out-dir", tmp_path / "none"]) == \
        f"No runs found under {tmp_path / 'port'}\n"


def _box_frames(root: Path, n: int, both: int, seed: int) -> Path:
    """``n`` drawn frames at 96x160; the first ``both`` have clear and
    unclear pedestrians, the rest clear ones only (every third none)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    rows = []
    for i in range(n):
        path = root / f"f{i}.jpg"
        if i != 3:   # frame 3's image is missing
            Image.fromarray(rng.integers(0, 255, (96, 160, 3), dtype=np.uint8)).save(path)
        unclear_n = int(rng.integers(1, 3)) if i < both else 0
        clear_n = int(rng.integers(1, 4)) if (i < both or i % 3) else 0
        k = clear_n + unclear_n
        x1, y1 = rng.uniform(0, 120, k), rng.uniform(0, 60, k)
        boxes = [[float(a), float(b), float(a + rng.uniform(3, 40)), float(b + rng.uniform(3, 36))]
                 for a, b in zip(x1, y1)]
        flags = [False] * clear_n + [True] * unclear_n
        rows.append({"frame_id": i * 7, "ped_count_clear": clear_n,
                     "ped_count_unclear": unclear_n, "resized_image_path": str(path),
                     "xyxy_bboxes": boxes,
                     "ped_unclear_list": None if i == 5 else (flags[:-1] if i == 1 else flags)})
    parquet = root / "frames.parquet"
    pd.DataFrame(rows).to_parquet(parquet)
    return parquet


@pytest.mark.parametrize("num_frames", [4, 30], ids=["both-pool", "clear-pool"])
def test_vis_boxes_draws_jax_jpegs(tmp_path, monkeypatch, num_frames):
    parquet = _box_frames(tmp_path / "frames", 24, both=9, seed=5)
    args = lambda out: ["--parquet", parquet, "--out-dir", out, "--num-frames", num_frames,  # noqa: E731
                        "--seed", 2]
    want = run_jax("vis_boxes", args(tmp_path / "jax"), monkeypatch)
    got = run_port("vis_boxes", args(tmp_path / "port"))
    assert got.replace(str(tmp_path / "port"), "OUT") == want.replace(str(tmp_path / "jax"), "OUT")
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir()) and files
    assert all(len(f) == len("000000.jpg") for f in files)
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert f"Wrote {len(files)} annotated frames" in got


@pytest.mark.parametrize("hw", [(704, 1248), (64, 96)], ids=["default", "small"])
def test_make_jpeg_is_jax_bytes(hw):
    assert port_cli("load_test_server")._make_jpeg(*hw) == \
        jax_script("load_test_server")._make_jpeg(*hw)


def test_notebook_cells_are_jax_cells(tmp_path, monkeypatch):
    import nbformat

    jax_nbs = {p.name: p.read_bytes() for p in (REPO / "notebooks").glob("zod_*.ipynb")}
    module = port_cli("build_qa_notebooks")
    monkeypatch.setattr(module, "OUT_DIR", tmp_path / "nb")
    out = run_port("build_qa_notebooks", ["--no-execute"])
    ref = jax_script("build_qa_notebooks")
    for name, make in zip(module.NOTEBOOKS, (ref.sanity_nb, ref.exploration_nb)):
        got = nbformat.read(tmp_path / "nb" / name, as_version=4)
        want = make()
        assert got.metadata["kernelspec"] == want.metadata["kernelspec"]
        assert [(c.cell_type, c.source) for c in got.cells] == [
            (c.cell_type, c.source.replace("multimodal_moe_tpu", "multimodal_moe_torch"))
            for c in want.cells]
        assert all(not c.get("outputs") for c in got.cells)
        assert f"wrote {tmp_path / 'nb' / name} ({len(want.cells)} cells, 0 with outputs)" in out
    assert {p.name: p.read_bytes() for p in (REPO / "notebooks").glob("zod_*.ipynb")} == jax_nbs


def test_committed_notebooks_were_built_and_run(monkeypatch):
    """The two committed notebooks are ``build_qa_notebooks``' cells (built from the
    repository root, ``sys.path`` given as ``'.'``), every code cell run
    without an error."""
    import nbformat

    module = port_cli("build_qa_notebooks")
    monkeypatch.setattr(module, "REPO", Path("."))
    for name, make in zip(module.NOTEBOOKS, (module.sanity_nb, module.exploration_nb)):
        nb = nbformat.read(REPO / "notebooks" / name, as_version=4)
        assert [(c.cell_type, c.source) for c in nb.cells] == [
            (c.cell_type, c.source) for c in make().cells]
        code = [c for c in nb.cells if c.cell_type == "code"]
        assert code and all(c.execution_count for c in code)
        assert not any(o.get("output_type") == "error" for c in code for o in c.outputs)
