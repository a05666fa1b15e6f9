"""The port's CLIs (``python -m multimodal_moe_torch.cli.<name>``) on the CPU
(``MMOE_PLATFORM=cpu``), against the JAX package's.

A tiny YOLO-n run dir is written by the JAX package's ``CheckpointManager``
(class heads scaled by 10, as tests/test_torch_evaluator.py does, so that
the scores spread) and converted by ``tools/orbax_to_torch.py``. Over five
seeded JPEGs of odd sizes (batch 2: the tail batch padded):

* the port's ``predict_detector`` and JAX's ``scripts/predict_detector.py``
  on the same run write ``predictions.json`` files with the same images,
  sizes and detection counts, boxes within 0.016 px and scores within
  1.1e-4 (tests/test_torch_server.py's tolerances), after the NMS
  decisions at conf 0.3 are shown well defined at the forward's tolerance;
* tests/test_predict_cli.py's cases against the port: ``--draw`` (the
  annotated copies), ``--int8`` self-calibrating (and writing its npz
  beside the checkpoint), ``--conf 0.999`` (exactly the detections of conf
  0.3 with a score at or above it); the first as a child process
  (``python -m``), the other two through the CLI's ``main`` in this
  process;
* ``serve_detector`` as a child process on ``--port 0``: its listening
  line, ``/healthz`` and one raw ``/predict`` equal, within the same
  tolerances, to an in-process ``BatchingDetector`` on the same run.

The weights' seed is one whose NMS decisions at conf 0.3 are well defined
(the check runs first in the parity test). Every subprocess has a timeout
and is stopped in ``finally``."""

import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_moe_torch import loading as tload
from multimodal_moe_torch.server import BatchingDetector
from multimodal_moe_tpu import loading as jload
from test_torch_evaluator import SCORE_THR, Pair, _assert_well_defined, _scaled_yolo_heads
from test_torch_orbax_convert import jax_loaded, jax_variables, load_tool, write_jax_run

REPO = Path(__file__).resolve().parents[1]
H, W, BATCH = 64, 128, 2
CFG = {"family": "yolo", "variant": "n"}
SIZES = [("a.jpg", (320, 180)), ("b.jpg", (640, 360)), ("c.jpg", (100, 80)),
         ("d.jpg", (257, 131)), ("e.jpg", (97, 203))]
CLI_TIMEOUT = 600
SEED = 6  # weights whose NMS decisions are well defined (checked below)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _env(threads: int):
    """A child's environment: the CPU, ``threads`` threads, no XLA cache."""
    return dict(os.environ, MMOE_PLATFORM="cpu", MMOE_XLA_CACHE="", OMP_NUM_THREADS=str(threads),
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
                PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))


def _predict_args(run, imgs, out, conf, *extra):
    return ["--weights", str(run), "--images", str(imgs), "--out", str(out),
            "--img-h", str(H), "--img-w", str(W), "--batch", str(BATCH),
            "--conf", str(conf), *extra]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The JAX run dir, its conversion, the JPEGs; JAX's predict CLI is
    started here and read by the last test, so the port's run beside it."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_cli")
    variables = _scaled_yolo_heads(jax_variables(CFG, seed=SEED))
    jrun, _ = write_jax_run(root / "jax", CFG, seed=SEED, names=("best",), variables=variables)
    (jrun / "weights" / "int8_quant_best.npz").unlink()  # int8 self-calibrates below
    prun = root / "port"
    load_tool().convert_run(jrun, prun)
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name, (w, h) in SIZES:
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(imgs / name)
    jax_cli = subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "predict_detector.py"),
         *_predict_args(jrun, imgs, root / "jax_preds", SCORE_THR)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(1))
    try:
        yield jrun, prun, imgs, root, jax_cli
    finally:
        if jax_cli.poll() is None:
            jax_cli.kill()
        jax_cli.communicate(timeout=60)


def _run_port_cli(run, imgs, out_dir, conf, *extra):
    """The port's predict CLI as a child process (``python -m``)."""
    return subprocess.run(
        [sys.executable, "-m", "multimodal_moe_torch.cli.predict_detector",
         *_predict_args(run, imgs, out_dir, conf, *extra)],
        capture_output=True, text=True, timeout=CLI_TIMEOUT, env=_env(2), cwd=REPO,
    )


def _main_port_cli(monkeypatch, run, imgs, out_dir, conf, *extra):
    """The port's predict CLI's ``main`` in this process (``MMOE_PLATFORM=cpu``)."""
    from multimodal_moe_torch.cli import predict_detector

    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    predict_detector.main(_predict_args(run, imgs, out_dir, conf, *extra))


def _preds(out_dir):
    return json.loads((out_dir / "predictions.json").read_text())


def test_predict_cli_end_to_end_with_draw(tiny_run):
    _, prun, imgs, root, _ = tiny_run
    out = _run_port_cli(prun, imgs, root / "port_preds", SCORE_THR, "--draw")
    assert out.returncode == 0, out.stderr[-2000:]
    preds = _preds(root / "port_preds")
    assert [p["image"] for p in preds] == [name for name, _ in SIZES]
    for p, (_, (w, h)) in zip(preds, SIZES):
        assert (p["width"], p["height"]) == (w, h)
        for det in p["detections"]:
            x1, y1, x2, y2 = det["xyxy"]
            assert 0 <= x1 <= w and 0 <= x2 <= w
            assert 0 <= y1 <= h and 0 <= y2 <= h
            assert SCORE_THR <= det["score"] <= 1.0
    assert sum(len(p["detections"]) for p in preds) >= 5
    for name, _ in SIZES:
        assert (root / "port_preds" / f"pred_{name}").exists()


def test_predict_cli_int8_self_calibrates(tiny_run, monkeypatch):
    """--int8 with no cached npz: scales calibrate on the input batches, the
    npz is written beside the checkpoint, the artifact keeps its schema."""
    _, prun, imgs, root, _ = tiny_run
    run = root / "port_int8"
    shutil.copytree(prun, run)
    _main_port_cli(monkeypatch, run, imgs, root / "pred_i8", 0.0, "--int8")
    preds = _preds(root / "pred_i8")
    assert len(preds) == len(SIZES)
    assert sum(len(p["detections"]) for p in preds) > 0
    assert (run / "weights" / "int8_quant_best.npz").exists()


def test_predict_cli_conf_filters(tiny_run, monkeypatch):
    _, prun, imgs, root, _ = tiny_run
    _main_port_cli(monkeypatch, prun, imgs, root / "pred_hi", 0.999)
    _main_port_cli(monkeypatch, prun, imgs, root / "pred_lo", SCORE_THR)
    hi, lo = _preds(root / "pred_hi"), _preds(root / "pred_lo")
    assert len(hi) == len(SIZES)
    # greedy NMS keeps a box by the boxes above it alone: conf 0.999 keeps
    # exactly the conf-0.3 detections scored at or above 0.999
    for h, l in zip(hi, lo):
        assert all(d["score"] != 0.999 for d in l["detections"])
        assert h["detections"] == [d for d in l["detections"] if d["score"] >= 0.999]


def _read_lines(stream, out: "queue.Queue[str]") -> None:
    for line in stream:
        out.put(line)


def test_serve_cli_round_trip(tiny_run):
    _, prun, imgs, _, _ = tiny_run
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_moe_torch.cli.serve_detector",
         "--weights", str(prun), "--port", "0", "--img-h", str(H), "--img-w", str(W),
         "--batch", str(BATCH), "--conf", "0.0", "--max-wait-ms", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(2), cwd=REPO)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=_read_lines, args=(proc.stdout, lines), daemon=True)
    reader.start()
    loaded = tload.load_detector(prun, img_h=H, img_w=W, device="cpu")
    det = BatchingDetector(loaded.model, loaded.variables, batch=BATCH, img_h=H, img_w=W,
                           conf=0.0, max_wait_ms=5.0)
    try:
        seen = []
        while not any("listening on" in line for line in seen):
            seen.append(lines.get(timeout=CLI_TIMEOUT))
        url = seen[-1].split("listening on ")[1].split()[0]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ok"] is True and health["batch"] == BATCH
        img = np.random.default_rng(9).integers(0, 255, (H, W, 3), dtype=np.uint8)
        req = urllib.request.Request(f"{url}/predict?conf={SCORE_THR}", data=img.tobytes(),
                                     headers={"Content-Type": "application/x-mmoe-raw"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            served = json.loads(resp.read())["detections"]
        local = det.submit(img, conf=SCORE_THR).result(timeout=120)
        assert len(served) == len(local) > 0
        for s, d in zip(served, local):
            np.testing.assert_allclose(s["xyxy"], d["xyxy"], rtol=0, atol=0.016)
            assert abs(s["score"] - d["score"]) <= 1.1e-4
        assert any("yolo from" in line for line in seen), seen
    finally:
        det.close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)


def _resized_batches(imgs):
    """The CLIs' batches: PIL bilinear resize, the tail padded."""
    from PIL import Image

    frames = []
    for name, _ in SIZES:
        with Image.open(imgs / name) as im:
            frames.append(np.asarray(im.convert("RGB").resize((W, H), Image.BILINEAR), np.uint8))
    frames += [np.zeros((H, W, 3), np.uint8)] * (-len(frames) % BATCH)
    return [{"image": np.stack(frames[i:i + BATCH]),
             "batch_valid": np.arange(i, i + BATCH) < len(SIZES)}
            for i in range(0, len(frames), BATCH)]


def test_predict_cli_matches_jax_cli(tiny_run):
    jrun, prun, imgs, root, jax_cli = tiny_run
    # the NMS decisions at conf 0.3 are well defined at the forward's tolerance
    jl = jax_loaded(jrun, "best", True, jax_variables(CFG, seed=SEED))
    _, jmodel = jload.build_detector(CFG)
    tl = tload.load_detector(prun, img_h=H, img_w=W, device="cpu")
    pair = Pair(jmodel, jl.variables, tl.model)
    batches = _resized_batches(imgs)
    _assert_well_defined(batches, [pair.anchor_outputs(b["image"]) for b in batches], 5e-3)

    if not (root / "port_preds").exists():
        out = _run_port_cli(prun, imgs, root / "port_preds", SCORE_THR)
        assert out.returncode == 0, out.stderr[-2000:]
    stdout, stderr = jax_cli.communicate(timeout=CLI_TIMEOUT)
    assert jax_cli.returncode == 0, stderr[-2000:]
    ref, got = _preds(root / "jax_preds"), _preds(root / "port_preds")
    assert [(p["image"], p["width"], p["height"]) for p in got] == \
        [(p["image"], p["width"], p["height"]) for p in ref]
    for g, r in zip(got, ref):
        assert len(g["detections"]) == len(r["detections"]), g["image"]
        for gd, rd in zip(g["detections"], r["detections"]):
            np.testing.assert_allclose(gd["xyxy"], rd["xyxy"], rtol=0, atol=0.016)
            assert abs(gd["score"] - rd["score"]) <= 1.1e-4
    assert sum(len(p["detections"]) for p in ref) >= 5
