"""The port's training CLIs (``python -m multimodal_moe_torch.cli.train_{yolo,
moe,rtdetr}``) on the CPU (``MMOE_PLATFORM=cpu``), against the JAX
package's scripts.

* Each of the five new CLIs' ``parse_args`` (the training ones,
  ``eval_detector`` and ``quantize_yolo``) against the JAX script's on the
  same argv, the defaults and a changed value of every kind: the parsed
  namespaces equal, every flag and default. No flag is left out.
* Runs of one or two epochs at 64×128, batch 4, on the synthetic frames of
  ``tests/conftest.py`` (``boxed_parquet``, ``split_csvs``: two steps an
  epoch, one validation batch), each checking its run dir:
  ``train_yolo`` YOLO-n paused by ``--max-epochs-this-run 1`` and resumed
  with ``--resume`` (``fit_progress.json`` at epoch 0, then 1);
  ``train_yolo --data-yaml --remat`` on a layout exported by JAX's
  ``export_yolo_split``; ``train_moe --resident`` MoE-YOLO-n with two
  experts as a child process on a pre-resized corpus, and on two gloo
  ranks (rank 0 validates over the whole val split)
  (``tests/_torch_data.py``); ``train_rtdetr`` with a 32-wide, 10-query,
  one-layer decoder and trunk depths (1, 1, 1, 1) (the flags give no
  depth: the constructor is patched), whose validation runs no NMS.
* One JAX ``scripts/train_yolo.py`` run at the YOLO run's settings (a child
  process, started first): the run dirs hold the same files, and every
  JSON and CSV the same keys, apart from the runtime record's (JAX names
  its JAX version and backend where the port names torch and CUDA:
  ``collect_runtime_info``) and the checkpoints' inner files (Orbax's
  against ``torch.save``'s).

On the card (``-m cuda``, skipped here): the resident loader's batches,
which lie on the card, validate through ``evaluate_detector`` (its ground
truth is read back to the host), as ``train_* --resident`` validates.

Torch runs two intra-op threads; every child has a timeout."""

import argparse
import csv
import functools
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_data import MAX_BOXES, write_corpus
from _torch_parity import require_cuda

REPO = Path(__file__).resolve().parents[1]
H, W, BATCH = 64, 128, 4
CHILD_TIMEOUT = 600
RUNTIME_KEYS = {"jax_version", "jax_backend", "torch_version", "cuda_version"}
FILES = {"model_config.json", "fit_progress.json", "train_summary.json", "train_summary.csv",
         "train_metrics.json", "run_metadata.json", "run_metadata.csv", "weights"}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _env(threads: int) -> dict:
    """A child's environment: the CPU, ``threads`` threads, no XLA cache,
    no stall watchdog."""
    return dict(os.environ, MMOE_PLATFORM="cpu", MMOE_XLA_CACHE="", MMOE_STALL_TIMEOUT_S="0",
                OMP_NUM_THREADS=str(threads),
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
                PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))


def _data_args(parquet, splits_dir, project, name, *extra):
    return ["--parquet", str(parquet), "--splits-dir", str(splits_dir), "--img-h", str(H),
            "--img-w", str(W), "--batch", str(BATCH), "--workers", "2",
            "--project", str(project), "--name", name, *extra]


@pytest.fixture(scope="module")
def data(boxed_parquet, split_csvs, tmp_path_factory):
    """The fixtures' paths, and JAX's train_yolo started on them."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    splits = Path(split_csvs["train"]).parent
    yolo_args = ["--model", "yolo-n", "--epochs", "2", "--max-epochs-this-run", "1"]
    jax_cli = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "train_yolo.py"),
         *_data_args(boxed_parquet, splits, root / "jax", "yolo", *yolo_args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(1))
    try:
        yield {"parquet": boxed_parquet, "splits": splits, "root": root, "jax": jax_cli,
               "yolo_args": yolo_args}
    finally:
        if jax_cli.poll() is None:
            jax_cli.kill()
        jax_cli.communicate(timeout=60)


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` to count its calls."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.fixture(scope="module")
def yolo_run(data):
    """The port's train_yolo, paused after one epoch then resumed; how many
    NMS calls its validations made; the progress file after each half."""
    from multimodal_moe_torch.cli import train_yolo
    from multimodal_moe_torch.train import evaluator

    args = _data_args(data["parquet"], data["splits"], data["root"] / "port", "yolo",
                      *data["yolo_args"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMOE_PLATFORM", "cpu")
        nms = _counting(mp, evaluator, "batched_nms")
        train_yolo.main(args)
        run = data["root"] / "port" / "yolo"
        first = json.loads((run / "fit_progress.json").read_text())
        train_yolo.main(args + ["--resume"])
    return {"run": run, "first": first, "nms": len(nms),
            "second": json.loads((run / "fit_progress.json").read_text())}


def _jax_parse(script: str, argv):
    """The JAX script's parsed namespace for ``argv`` (``quantize_yolo``
    parses inside ``main``: its parser is stopped right after parsing)."""
    class Parsed(Exception):
        pass

    scripts = str(REPO / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMOE_XLA_CACHE", "")
        mp.setattr(sys, "argv", [script, *argv])
        module = importlib.import_module(script)
        if hasattr(module, "parse_args"):
            return module.parse_args()
        parse = argparse.ArgumentParser.parse_args

        def stop(self, *a, **k):
            raise Parsed(parse(self, *a, **k))

        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(Parsed) as parsed:
            module.main()
        return parsed.value.args[0]


ARGV = {
    "train_yolo": [[], ["--model", "yolo-n", "--data-yaml", "d.yaml", "--epochs", "3",
                        "--lrf", "0.1", "--optimizer", "adamw", "--eval-every", "0", "--remat",
                        "--resident", "--stream-store", "rgb", "--max-epochs-this-run", "2",
                        "--resume", "--workers", "1"]],
    "train_moe": [[], ["--variant", "n", "--num-experts", "2", "--top-k", "1",
                       "--capacity-factor", "2.0", "--expert-parallel", "2", "--remat",
                       "--lr0", "0.5", "--max-boxes", "7", "--unclear-policy", "include"]],
    "train_rtdetr": [[], ["--no-remat", "--hidden-dim", "64", "--num-queries", "20",
                          "--decoder-layers", "2", "--patience", "3", "--seed", "4"],
                     ["--remat"]],
    "eval_detector": [["--weights", "w"],
                      ["--weights", "w", "--backend", "rtdetr", "--checkpoint", "last",
                       "--split", "test", "--run-name", "r", "--nms-iou", "0.5", "--no-use-ema",
                       "--int8", "--int8-calib-batches", "2", "--int8-recalibrate",
                       "--int8-fp-box", "--int8-calib-mode", "avgmax"]],
    "quantize_yolo": [["--weights", "w"],
                      ["--weights", "w", "--checkpoint", "last", "--calib-batches", "3",
                       "--no-use-ema", "--out", "q.npz", "--img-h", "32"]],
}


@pytest.mark.parametrize("script", sorted(ARGV))
def test_parse_args_match_jax(script):
    port = importlib.import_module(f"multimodal_moe_torch.cli.{script}")
    for argv in ARGV[script]:
        assert vars(port.parse_args(argv)) == vars(_jax_parse(script, argv)), argv


def _keys(path: Path):
    if path.suffix == ".json":
        data = json.loads(path.read_text())
        if path.name == "fit_progress.json":
            return set(data), {k for row in data["history"] for k in row}
        return set(data)
    with path.open() as f:
        return {row[0] for row in csv.reader(f)}


def _assert_run_dir(run: Path):
    assert set(os.listdir(run)) == FILES
    assert {"best", "last"} <= set(os.listdir(run / "weights"))
    summary = json.loads((run / "train_summary.json").read_text())
    assert summary["params_total"] == summary["params_trainable"] > 0
    metrics = json.loads((run / "train_metrics.json").read_text())
    assert "loss" in metrics and "val_map50" in metrics
    meta = json.loads((run / "run_metadata.json").read_text())
    assert meta["torch_version"] == torch.__version__
    return summary, meta


def test_yolo_pauses_and_resumes(yolo_run):
    run = yolo_run["run"]
    assert yolo_run["first"]["epoch"] == 0 and yolo_run["second"]["epoch"] == 1
    assert len(yolo_run["second"]["history"]) == 2
    summary, meta = _assert_run_dir(run)
    assert summary["epochs_run"] == 2 and summary["model_name"] == "yolo-n"
    assert meta["model_family"] == "yolo" and meta["epochs"] == 2
    from multimodal_moe_torch.models.yolo import YoloDetector, count_params

    assert summary["params_total"] == count_params(YoloDetector(variant="n"))
    assert json.loads((run / "model_config.json").read_text()) == {
        "family": "yolo", "variant": "n", "num_classes": 1, "optimizer": "sgd",
        "img_h": H, "img_w": W}
    assert yolo_run["nms"] == 2  # one validation batch an epoch, each through NMS


def test_yolo_data_yaml_with_remat(data, boxed_parquet, split_csvs, monkeypatch):
    from multimodal_moe_torch.cli import train_yolo
    from multimodal_moe_torch.data import yolo_layout
    from multimodal_moe_torch.models import yolo
    from multimodal_moe_tpu.data.exports import export_yolo_split, write_yolo_dataset_yaml
    from multimodal_moe_tpu.data.index import load_split_frames

    layout = data["root"] / "layout"
    for split in ("train", "val"):
        export_yolo_split(split_name=split, out_dataset_dir=layout,
                          frames_df=load_split_frames(boxed_parquet, split_csvs[split]))
    write_yolo_dataset_yaml(layout, {0: "pedestrian"})
    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    loads = _counting(monkeypatch, yolo_layout.YoloLayoutDataset, "load")
    remat = []
    built = yolo.YoloDetector
    monkeypatch.setattr(yolo, "YoloDetector",
                        lambda *a, **k: remat.append(k.get("remat")) or built(*a, **k))
    train_yolo.main(_data_args(data["parquet"], data["splits"], data["root"] / "port", "layout",
                               "--model", "yolo-n", "--epochs", "1", "--remat",
                               "--data-yaml", str(layout / "dataset.yaml")))
    assert remat == [True] and len(loads) >= 10   # 8 train and 2 val frames
    _assert_run_dir(data["root"] / "port" / "layout")


def test_moe_resident_as_a_child(data):
    corpus = write_corpus(data["root"] / "presized", 8, seed=2)
    project = data["root"] / "port"
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_moe_torch.cli.train_moe",
         *_data_args(corpus["parquet"], corpus["root"], project, "moe", "--variant", "n",
                     "--num-experts", "2", "--epochs", "1", "--resident", "--max-boxes", "3")],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT, env=_env(2), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[resident] 8 samples" in proc.stderr
    summary, meta = _assert_run_dir(project / "moe")
    assert summary["model_name"] == "moe-yolo-n-e2"
    assert meta["model_variant"] == "n-e2k2" and meta["expert_parallel"] == 1
    config = json.loads((project / "moe" / "model_config.json").read_text())
    assert config["dispatch"] == "auto" and config["num_experts"] == 2
    assert config["effective_dispatch_at_train_batch"] == {"P3": "dense", "P4": "dense",
                                                           "P5": "dense"}
    assert "moe_aux_loss" in json.loads((project / "moe" / "train_metrics.json").read_text())


def test_moe_resident_on_two_ranks_validates_the_whole_split(data):
    """``train_moe --resident`` on two gloo ranks: each rank keeps its shard
    of the train split resident, and rank 0 validates over every val frame
    (the resident val loader is not sharded), so every rank's history
    counts the whole split."""
    from multimodal_moe_torch.parallel.distributed import run_ranks

    corpus = write_corpus(data["root"] / "presized2", 8, seed=4)
    n_val = len(corpus["val"].read_text().split()) - 1
    project = data["root"] / "port2"
    run_ranks([sys.executable, "-m", "multimodal_moe_torch.cli.train_moe",
               *_data_args(corpus["parquet"], corpus["root"], project, "moe", "--variant", "n",
                           "--num-experts", "2", "--epochs", "1", "--resident",
                           "--max-boxes", "3")],
              2, env=_env(1), timeout=CHILD_TIMEOUT, cwd=REPO)
    history = json.loads((project / "moe" / "fit_progress.json").read_text())["history"]
    assert n_val == 3 and history[-1]["val_n_images"] == n_val
    _assert_run_dir(project / "moe")


def test_rtdetr_validates_without_nms(data, monkeypatch):
    from multimodal_moe_torch.cli import train_rtdetr
    from multimodal_moe_torch.models import rtdetr
    from multimodal_moe_torch.train import evaluator

    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    monkeypatch.setattr(rtdetr, "RTDETRDetector",
                        functools.partial(rtdetr.RTDETRDetector, backbone_depths=(1, 1, 1, 1)))
    nms = _counting(monkeypatch, evaluator, "batched_nms")
    topk = _counting(monkeypatch, evaluator, "detr_topk_select")
    train_rtdetr.main(_data_args(data["parquet"], data["splits"], data["root"] / "port", "rt",
                                 "--epochs", "1", "--hidden-dim", "32", "--num-queries", "10",
                                 "--decoder-layers", "1", "--max-boxes", "8"))
    assert nms == [] and len(topk) == 1
    summary, meta = _assert_run_dir(data["root"] / "port" / "rt")
    assert summary["model_name"] == "rtdetr-r50vd" and meta["model_variant"] == "r50vd"
    config = json.loads((data["root"] / "port" / "rt" / "model_config.json").read_text())
    assert config["optimizer"] == "adamw" and config["hidden_dim"] == 32


@pytest.mark.cuda
def test_resident_batches_validate_on_the_card(tmp_path):
    dev = require_cuda()
    from multimodal_moe_torch.data.pipeline import ZODMoEDataConfig, ZODMoEVisionDataset
    from multimodal_moe_torch.data.resident import ResidentDetectionLoader
    from multimodal_moe_torch.models.yolo import YoloDetector
    from multimodal_moe_torch.train.evaluator import evaluate_detector, make_inference_fn

    corpus = write_corpus(tmp_path / "c", 6, seed=3)
    ds = ZODMoEVisionDataset(ZODMoEDataConfig(
        frames_parquet=str(corpus["parquet"]), split_csv=str(corpus["train"]), img_h=H, img_w=W,
        max_boxes=MAX_BOXES))
    loader = ResidentDetectionLoader(ds, 4, drop_last=False, store="rgb", device=dev)
    assert next(iter(loader))["gt_boxes"].is_cuda
    model = YoloDetector(variant="n").to(dev).eval()
    metrics = evaluate_detector(iter(loader), make_inference_fn(model, dict(model.state_dict())),
                                device=dev)
    assert metrics["n_images"] == 6 and "map50" in metrics


def test_run_dir_keys_match_jax(data, yolo_run):
    """Last in the file: JAX's run, started by the first fixture, compiles
    while the tests above run."""
    stdout, stderr = data["jax"].communicate(timeout=CHILD_TIMEOUT)
    assert data["jax"].returncode == 0, stderr[-3000:]
    jrun, prun = data["root"] / "jax" / "yolo", yolo_run["run"]
    assert set(os.listdir(jrun)) == set(os.listdir(prun)) == FILES
    assert set(os.listdir(jrun / "weights")) >= {"best", "last"}
    for name in sorted(FILES - {"weights"}):
        got, want = _keys(prun / name), _keys(jrun / name)
        if name.startswith("run_metadata"):
            got, want = got - RUNTIME_KEYS, want - RUNTIME_KEYS
        assert got == want, name
