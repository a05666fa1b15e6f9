"""The port's ``train/artifacts.py`` against the JAX package's (CPU): the
same files with the same bytes for the same dicts, and a runtime record with
torch and CUDA keys that does not fail without a card."""

import json

import pytest
import torch

from multimodal_moe_torch.train import artifacts as tart
from multimodal_moe_tpu.train import artifacts as jart

METRICS = {
    "map50": 0.5123456789, "map50_95": 0.31, "precision": 0.7, "recall": 0.65,
    "speed_preprocess_ms_per_img": 1.25, "speed_inference_ms_per_img": 3.5,
    "speed_postprocess_ms_per_img": 0.75, "n_images": 12, "params": None,
    "curves_results": {"pr": [[0.0, 1.0], [1.0, 0.5]]}, "names": ["a", "b"],
    "flag": True, "ünïcode": "ü",
}


def _bytes(path):
    return path.read_bytes()


def test_metrics_json_and_table(tmp_path):
    for name, writer in (("metrics.json", "save_metrics_json"),
                         ("metrics_table.csv", "save_metrics_table_csv")):
        a = getattr(tart, writer)(METRICS, tmp_path / "torch" / name)
        b = getattr(jart, writer)(METRICS, tmp_path / "jax" / name)
        assert a.name == b.name == name
        assert _bytes(a) == _bytes(b)


def test_run_metadata_and_training_summary(tmp_path):
    meta = {"family": "yolo", "variant": "s", "weights": "runs/x/weights/best",
            "seed": 0, "img_h": 704, "img_w": 1248, "runtime": {"host": "h"}}
    got = tart.save_run_metadata_artifacts(meta, tmp_path / "t" / "m.json", tmp_path / "t" / "m.csv")
    ref = jart.save_run_metadata_artifacts(meta, tmp_path / "j" / "m.json", tmp_path / "j" / "m.csv")
    for a, b in zip(got, ref):
        assert _bytes(a) == _bytes(b)
    kw = dict(train_wall_time_s=12.5, model_name="yolo_s", data_yaml="d.yaml", run_name="r",
              params_total=123, params_trainable=120, flops_g=None, extra={"epochs": 2})
    got = tart.save_training_summary(out_json_path=tmp_path / "t" / "s.json",
                                     out_csv_path=tmp_path / "t" / "s.csv", **kw)
    ref = jart.save_training_summary(out_json_path=tmp_path / "j" / "s.json",
                                     out_csv_path=tmp_path / "j" / "s.csv", **kw)
    for a, b in zip(got, ref):
        assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("speeds", [
    {"speed_preprocess_ms_per_img": 1.0, "speed_inference_ms_per_img": 4.0,
     "speed_postprocess_ms_per_img": 0.5},
    {"speed_inference_ms_per_img": 0.0},
    {"speed_preprocess_ms_per_img": "n/a", "speed_inference_ms_per_img": 2,
     "speed_postprocess_ms_per_img": None},
    {},
])
def test_derived_speed_metrics(speeds):
    assert tart.add_derived_speed_metrics(dict(speeds)) == jart.add_derived_speed_metrics(dict(speeds))


def test_variant_from_weights():
    for name in ("yolo11s.pt", "runs/a/best", "model.tar.gz"):
        assert tart.infer_model_variant_from_weights(name) == jart.infer_model_variant_from_weights(name)


def test_runtime_info_names_torch_and_the_card(monkeypatch):
    info = tart.collect_runtime_info()
    assert {"hostname", "platform", "python_version", "torch_version", "cuda_version",
            "device_count", "device_kind"} <= set(info)
    assert info["torch_version"] == torch.__version__
    json.dumps(info)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = tart.collect_runtime_info()
    assert info["device_count"] == 0 and info["device_kind"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    info = tart.collect_runtime_info()
    assert info["device_count"] == 1 and info["device_kind"] == "NVIDIA H100 80GB HBM3"
