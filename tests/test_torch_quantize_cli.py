"""The port's ``eval_detector --int8`` and ``quantize_yolo`` CLIs on the CPU
(``MMOE_PLATFORM=cpu``), against the JAX package's ``scripts/quantize_yolo.py``
on the same run (tests/test_torch_eval_cli.py's YOLO-n run, converted by
``tools/orbax_to_torch.py``; the synthetic frames at 64×128, batch 2: the
train split's eight frames make four calibration batches).

* ``eval_detector --int8`` on the converted run calibrates on the train
  split and writes ``int8_quant_best.npz``, which JAX's ``load_quant_npz``
  reads; against the npz of JAX's ``quantize_yolo`` on the JAX run (a child
  process, started first): the same leaves, every weight leaf (codes,
  weight scales, folded biases) bitwise and every activation scale within
  1e-5 relative (``calibrate``'s tolerance in tests/test_torch_quant.py,
  whose fold and tree from JAX's own statistics are bitwise). A second
  ``--int8`` reuses the npz; ``metrics.json`` says ``quantization``.
* ``quantize_yolo`` on a copy of the converted run whose checkpoint holds
  no optimizer state (``restore_eval``, where JAX's script calls
  ``restore``): its npz bitwise the eval CLI's (the same calibration
  batches).

Torch runs two intra-op threads; the child has a timeout."""

import shutil

import numpy as np
import pytest
import torch

from multimodal_moe_torch import loading as tload
from multimodal_moe_tpu import quant as jq
from test_torch_eval_cli import (  # noqa: F401  (two_threads, small_rtdetr_trunk: autouse)
    H,
    W,
    port_cli,
    read_outputs,
    small_rtdetr_trunk,
    start_runs,
    stop_children,
    two_threads,
    wait,
)


@pytest.fixture(scope="module")
def runs(boxed_parquet, split_csvs, tmp_path_factory):
    """YOLO's run, JAX's quantize script started on it."""
    out = start_runs(boxed_parquet, split_csvs, tmp_path_factory.mktemp("torch_quantize_cli"),
                     ("yolo",), quantize=True)
    try:
        yield out
    finally:
        stop_children(out)


def test_int8_npz_matches_jax_quantize(runs, monkeypatch, capsys):
    prun = runs["port"]["yolo"]
    port_cli(monkeypatch, runs, "eval_detector", "--weights", str(prun), "--int8",
              "--run-name", "int8")
    assert "Calibrated on 4 train batches (absmax)" in capsys.readouterr().out
    metrics, meta = read_outputs(runs["root"] / "port_eval" / "yolo" / "int8")
    assert metrics["quantization"] == meta["quantization"] == "int8_w8a8_ptq"
    npz = prun / "weights" / "int8_quant_best.npz"
    wait(runs, "quantize")
    got = {k: np.asarray(v) for k, v in np.load(npz).items()}
    want = {k: np.asarray(v) for k, v in np.load(runs["root"] / "jax_quant.npz").items()}
    assert set(got) == set(want) and len(want) > 100
    jq.load_quant_npz(npz)   # JAX reads the port's file
    scales = [k for k in want if k.split("/")[-1] not in ("w_q", "s_w", "b")]
    assert scales and len(scales) < len(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in scales:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # A second run reuses the cached tree.
    port_cli(monkeypatch, runs, "eval_detector", "--weights", str(prun), "--int8",
              "--run-name", "int8_cached")
    assert f"Loaded int8 quant tree <- {npz}" in capsys.readouterr().out


def test_quantize_converted_run(runs, monkeypatch, capsys, tmp_path):
    """The converted run carries JAX's optimizer state; a copy of it whose
    checkpoint has none (``restore`` would refuse it) quantizes all the
    same: ``quantize_yolo`` reads the weights by ``restore_eval``."""
    prun = runs["port"]["yolo"]
    raw = torch.load(prun / "weights" / "best" / "state.pt", weights_only=False)
    assert "opt_state" in raw
    bare = tmp_path / "bare"
    (bare / "weights" / "best").mkdir(parents=True)
    shutil.copyfile(prun / "model_config.json", bare / "model_config.json")
    torch.save({k: v for k, v in raw.items() if k != "opt_state"},
               bare / "weights" / "best" / "state.pt")
    out = tmp_path / "q.npz"
    port_cli(monkeypatch, runs, "quantize_yolo", "--weights", str(bare), "--out", str(out))
    assert "Calibrated on 4 batches @ 64x128;" in capsys.readouterr().out
    cached = prun / "weights" / "int8_quant_best.npz"
    if not cached.exists():   # the --int8 test above writes it; alone, write it here
        tload.quantize_loaded(tload.load_detector(prun, img_h=H, img_w=W, device="cpu"),
                              _calib(runs))
    got, want = np.load(out), np.load(cached)
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _calib(runs):
    from multimodal_moe_torch.cli.eval_detector import calib_batches, parse_args

    return list(calib_batches(parse_args(["--weights", "w", *runs["data"]]), 8))
