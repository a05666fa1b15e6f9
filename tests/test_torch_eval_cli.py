"""The port's ``eval_detector`` CLI on the CPU (``MMOE_PLATFORM=cpu``),
against the JAX package's ``scripts/eval_detector.py`` on the same run.

A YOLO-n and a small RT-DETR run dir (hidden 64, 20 queries, two decoder
layers, trunk depths (1, 1, 1, 1)) are written by the JAX package's
``CheckpointManager`` (``test_torch_orbax_convert.write_jax_run``; YOLO's
class heads scaled by 10, as tests/test_torch_evaluator.py does, so that
the scores spread) and converted by ``tools/orbax_to_torch.py``. Over the
synthetic frames of ``tests/conftest.py`` at 64×128, batch 2, the port's
CLI on the converted run and JAX's on the JAX run (a child process started
as soon as the run is written; RT-DETR's with the JAX constructor patched
to the small trunk, the port's ``build_detector`` likewise) each write
under their own ``EVAL_DIR``: the same files; ``metrics.json`` and
``run_metadata.json`` with the same keys (but the runtime record's:
``collect_runtime_info``); every metric within
tests/test_torch_evaluator.py's ``METRIC_TOL`` (the stage timings and the
fps derived from them aside), ``params_total`` equal, ``flops_g`` 1.0–1.2×
XLA's (``model_flops_g`` counts products and convolutions only); the
metadata's values equal but the weights' path and the runtime record.

``--int8`` and ``quantize_yolo`` are held in tests/test_torch_quantize_cli.py
(on runs made by this file's helpers). Torch runs two intra-op threads;
every child has a timeout."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_moe_torch import paths as tpaths
from test_torch_evaluator import METRIC_TOL, _scaled_yolo_heads
from test_torch_orbax_convert import (  # noqa: F401  (small_rtdetr_trunk: autouse)
    CONFIGS,
    SMALL_DEPTHS,
    jax_variables,
    load_tool,
    small_rtdetr_trunk,
    write_jax_run,
)

REPO = Path(__file__).resolve().parents[1]
H, W, BATCH = 64, 128, 2
CHILD_TIMEOUT = 600
RUNTIME_KEYS = {"jax_version", "jax_backend", "torch_version", "cuda_version"}
TIMED = ("speed_", "fps_")
# The JAX eval script with its RT-DETR constructor given the small trunk
# (model_config.json has no key for the depths).
SMALL_TRUNK_MAIN = """
import functools, runpy, sys
sys.path.insert(0, sys.argv[1])
import multimodal_moe_tpu.models.rtdetr as r
r.RTDETRDetector = functools.partial(r.RTDETRDetector, backbone_depths={depths})
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _env(eval_dir: Path) -> dict:
    """A child's environment: the CPU, one thread, no XLA cache, no stall
    watchdog, its own ``EVAL_DIR``."""
    return dict(os.environ, MMOE_PLATFORM="cpu", MMOE_XLA_CACHE="", MMOE_STALL_TIMEOUT_S="0",
                OMP_NUM_THREADS="1", EVAL_DIR=str(eval_dir),
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
                PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))


def start_runs(boxed_parquet, split_csvs, root: Path, families, quantize: bool) -> dict:
    """The JAX runs of ``families`` and their conversions, with JAX's eval
    script started on each (``quantize``: JAX's quantize script on YOLO's
    instead), each as soon as its run is written."""
    tool = load_tool()
    data = ["--parquet", str(boxed_parquet), "--splits-dir", str(Path(split_csvs["train"]).parent),
            "--img-h", str(H), "--img-w", str(W), "--batch", str(BATCH)]
    out = {"root": root, "data": data, "jax": {}, "port": {}, "children": {}}
    scripts = REPO / "scripts"

    def start(name, *argv):
        out["children"][name] = subprocess.Popen(
            [sys.executable, *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(root / "jax_eval"))

    for family in families:
        variables = jax_variables(CONFIGS[family], seed=6)
        if family == "yolo":
            variables = _scaled_yolo_heads(variables)
        jrun, _ = write_jax_run(root / "jax", CONFIGS[family], seed=6, names=("best",),
                                variables=variables)
        (jrun / "weights" / "int8_quant_best.npz").unlink()
        out["jax"][family] = jrun
        eval_args = ["--backend", family, "--weights", str(jrun), "--run-name", family, *data]
        if quantize:
            start("quantize", str(scripts / "quantize_yolo.py"), "--weights", str(jrun),
                  "--out", str(root / "jax_quant.npz"), *data)
        elif family == "yolo":
            start("eval_yolo", str(scripts / "eval_detector.py"), *eval_args)
        else:
            start("eval_rtdetr", "-c", SMALL_TRUNK_MAIN.format(depths=SMALL_DEPTHS),
                  str(scripts), str(scripts / "eval_detector.py"), *eval_args)
    for family, jrun in out["jax"].items():
        out["port"][family] = root / "port" / family
        tool.convert_run(jrun, out["port"][family])
    return out


def stop_children(out: dict) -> None:
    for child in out["children"].values():
        if child.poll() is None:
            child.kill()
        child.communicate(timeout=60)


@pytest.fixture(scope="module")
def runs(boxed_parquet, split_csvs, tmp_path_factory):
    """YOLO's and RT-DETR's runs, JAX's eval script started on each."""
    out = start_runs(boxed_parquet, split_csvs, tmp_path_factory.mktemp("torch_eval_cli"),
                     ("yolo", "rtdetr"), quantize=False)
    try:
        yield out
    finally:
        stop_children(out)


def wait(runs, name):
    child = runs["children"][name]
    _, stderr = child.communicate(timeout=CHILD_TIMEOUT)
    assert child.returncode == 0, stderr[-3000:]


def port_cli(monkeypatch, runs, module, *argv):
    """A port CLI's ``main`` in this process on the CPU, writing under the
    test's ``EVAL_DIR``."""
    import importlib

    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    monkeypatch.setattr(tpaths, "EVAL_DIR", runs["root"] / "port_eval")
    importlib.import_module(f"multimodal_moe_torch.cli.{module}").main([*argv, *runs["data"]])


def _assert_metrics_match(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith(TIMED):
            continue
        if k == "flops_g":
            assert 1.0 <= got[k] / v <= 1.2, (got[k], v)
        elif k == "curves_results":
            assert json.dumps(got[k], sort_keys=True).count(",") == \
                json.dumps(v, sort_keys=True).count(",")
            for g, w in zip(got[k], v):
                assert set(g) == set(w)
                for key, value in w.items():
                    if isinstance(value, str):
                        assert g[key] == value, key
                    else:
                        np.testing.assert_allclose(np.asarray(g[key], float),
                                                   np.asarray(value, float), rtol=0,
                                                   atol=METRIC_TOL, err_msg=key)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=METRIC_TOL, err_msg=k)
        else:
            assert got[k] == v, k


def read_outputs(out_dir: Path):
    assert {p.name for p in out_dir.iterdir()} == {
        "metrics.json", "metrics_table.csv", "run_metadata.json", "run_metadata.csv"}
    return (json.loads((out_dir / "metrics.json").read_text()),
            json.loads((out_dir / "run_metadata.json").read_text()))


@pytest.mark.parametrize("family", ["yolo", "rtdetr"])
def test_eval_matches_jax(runs, family, monkeypatch):
    port_cli(monkeypatch, runs, "eval_detector", "--backend", family, "--weights",
              str(runs["port"][family]), "--run-name", family)
    wait(runs, f"eval_{family}")
    got, got_meta = read_outputs(runs["root"] / "port_eval" / family / family)
    want, want_meta = read_outputs(runs["root"] / "jax_eval" / family / family)
    assert got["n_images"] == want["n_images"] == 2
    _assert_metrics_match(got, want)
    assert set(got_meta) - RUNTIME_KEYS == set(want_meta) - RUNTIME_KEYS
    # The same values but the weights' path and the runtime record.
    for k in set(want_meta) - RUNTIME_KEYS - {"model_weights", "hostname", "platform",
                                              "python_version", "device_count", "device_kind"}:
        assert got_meta[k] == want_meta[k], k
    assert got_meta["quantization"] == "none" and got_meta["model_family"] == family
