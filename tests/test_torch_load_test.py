"""The port's load test (``cli/load_test_server.py``) on the CPU
(``MMOE_PLATFORM=cpu``), against the JAX package's
``scripts/load_test_server.py``.

A tiny YOLO-n run dir is written by the JAX package's ``CheckpointManager``
and converted by ``tools/orbax_to_torch.py`` (as ``tests/test_torch_cli.py``
does). The port's load test runs in process at 64x96, batch 4, with raw
bodies at two levels (1 and 2 clients), with JPEG bodies at 2 clients,
and once with ``--int8`` (self-calibrating at one client); 3 s windows,
so that a level completes requests while other test workers load the
CPU. JAX's script runs in process with ``--int8`` against a stub detector
(its ``load_detector``, ``quantize_loaded`` and ``BatchingDetector``
replaced: its serving step would compile), behind its own HTTP server and
clients, for what the script itself writes and prints. Checked:

* ``load_test.json`` has JAX's keys, at the top and in every level; every
  level has 0 errors, device calls, completions, percentiles and a mean
  batch fill in [1, batch]; the printed level lines and table have JAX's
  form;
* the ``--int8`` calibration batch is JAX's draw, bitwise (the port's as
  ``quantize_loaded`` receives it, JAX's as its ``quantize_loaded``
  receives it), and the int8 run writes its npz beside the checkpoint.
"""

import contextlib
import importlib.util
import io
import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_orbax_convert import load_tool, write_jax_run

REPO = Path(__file__).resolve().parents[1]
H, W, BATCH = 64, 96, 4
CFG = {"family": "yolo", "variant": "n"}
PAYLOAD_KEYS = {"weights", "int8", "batch", "max_wait_ms", "duration_s", "levels"}
DURATION = 3.0   # a level's timed window, after a ramp of a third of it


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("load_test")
    jrun, _ = write_jax_run(root / "jax", CFG, seed=3, names=("best",))
    (jrun / "weights" / "int8_quant_best.npz").unlink()   # --int8 self-calibrates
    prun = root / "port"
    load_tool().convert_run(jrun, prun)
    return prun


def jax_script():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location("jax_load_test_server",
                                                      REPO / "scripts" / "load_test_server.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


def args_for(run, out, *extra):
    return ["--weights", str(run), "--img-h", str(H), "--img-w", str(W), "--batch", str(BATCH),
            "--out-dir", str(out), *map(str, extra)]


def run_port(monkeypatch, argv) -> str:
    from multimodal_moe_torch.cli import load_test_server

    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        load_test_server.main(argv)
    return out.getvalue()


def check_run(text: str, out_dir: Path, levels: list, int8: bool = False) -> dict:
    payload = json.loads((out_dir / "load_test.json").read_text())
    assert set(payload) == PAYLOAD_KEYS and payload["int8"] is int8
    assert payload["batch"] == BATCH and [r["concurrency"] for r in payload["levels"]] == levels
    lines = [json.loads(line) for line in text.splitlines() if line.startswith('{"section"')]
    assert [{k: v for k, v in line.items() if k != "section"} for line in lines] == \
        payload["levels"]
    for row in payload["levels"]:
        assert row["errors"] == 0 and row["device_calls"] > 0 and row["req_s"] > 0, row
        assert 1.0 <= row["mean_batch_fill"] <= BATCH, row
        assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"], row
    table = [line for line in text.splitlines() if line.startswith("|")]
    assert table[0] == f"| clients | req/s | p50 ms | p95 ms | p99 ms | mean fill /{BATCH} | errors |"
    assert len(table) == 2 + len(levels)
    assert text.splitlines()[-1] == f"[load] wrote {out_dir / 'load_test.json'}"
    return payload


class StubDetector:
    """What JAX's server and script use of a ``BatchingDetector``."""

    def __init__(self, model, variables, *, batch, img_h, img_w, **kw):
        self.batch, self.img_h, self.img_w = batch, img_h, img_w
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "device_calls": 0, "batched_images": 0}

    def warmup(self):
        pass

    def predict(self, image, **kw):
        with self._lock:
            self.stats["device_calls"] += 1
            self.stats["batched_images"] += 1
        return []

    def close(self):
        pass


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX's script with ``--int8 --raw`` against the stub detector: its
    output, its ``load_test.json`` and the calibration batches it made."""
    from multimodal_moe_tpu import loading, server

    out_dir = tmp_path_factory.mktemp("jax_load")
    seen = []

    def quantize(loaded, calib, fp_box=False):
        seen.append([np.asarray(c) for c in calib])
        return loaded

    module = jax_script()
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MMOE_XLA_CACHE", "")
        mp.setattr(loading, "load_detector",
                   lambda *a, **k: type("Loaded", (), {"model": None, "variables": None}))
        mp.setattr(loading, "quantize_loaded", quantize)
        mp.setattr(server, "BatchingDetector", StubDetector)
        mp.setattr(sys, "argv", ["load_test_server.py",
                                 *args_for("jaxrun", out_dir, "--int8", "--raw",
                                           "--concurrency", "1", "--duration", "1.5")])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        mp.undo()
    return {"text": out.getvalue(), "payload": json.loads((out_dir / "load_test.json").read_text()),
            "out_dir": out_dir, "calib": seen}


def test_jax_script_writes_these_keys(jax_reference):
    ref = jax_reference
    assert set(ref["payload"]) == PAYLOAD_KEYS
    check_run(ref["text"], ref["out_dir"], [1], int8=True)


@pytest.mark.parametrize("raw,levels", [(True, [1, 2]), (False, [2])], ids=["raw", "jpeg"])
def test_load_test_levels(run_dir, tmp_path, monkeypatch, jax_reference, raw, levels):
    out_dir = tmp_path / "out"
    text = run_port(monkeypatch, args_for(run_dir, out_dir,
                                          "--concurrency", ",".join(map(str, levels)),
                                          "--duration", DURATION, *(["--raw"] if raw else [])))
    payload = check_run(text, out_dir, levels)
    assert payload["weights"] == str(run_dir) and payload["duration_s"] == DURATION
    ref_levels = jax_reference["payload"]["levels"]
    assert all(set(row) == set(ref_levels[0]) for row in payload["levels"])
    assert text.splitlines()[0] == jax_reference["text"].splitlines()[0] == \
        "[load] compiling serving step..."


def test_int8_calibrates_on_jax_draw(run_dir, tmp_path, monkeypatch, jax_reference):
    from multimodal_moe_torch import loading

    seen, real = [], loading.quantize_loaded

    def recording(loaded, calib, **kw):
        calib = list(calib)
        seen.append([np.asarray(c) for c in calib])
        return real(loaded, calib, **kw)

    monkeypatch.setattr(loading, "quantize_loaded", recording)
    out_dir = tmp_path / "out"
    text = run_port(monkeypatch, args_for(run_dir, out_dir, "--int8", "--raw",
                                          "--concurrency", "1", "--duration", DURATION))
    check_run(text, out_dir, [1], int8=True)
    (got,), (want,) = seen, jax_reference["calib"]
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype == np.float32 and got[0].shape == (2, H, W, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert (run_dir / "weights" / "int8_quant_best.npz").exists()
    assert re.search(r"\| 1 \| [\d.]+ \|", text)
