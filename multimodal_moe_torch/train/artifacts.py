"""Run-artifact writers: the uniform schema every model family emits.

Counterpart of ``multimodal_moe_tpu/train/artifacts.py``: the same files,
and the same bytes for the same dicts (``tests/test_torch_artifacts.py``).
Files per run under ``outputs/eval/<family>/<run>/``:

* ``metrics.json``       — map50, map50_95, precision, recall,
  ``speed_*_ms_per_img``, ``fps_*``, params/flops, optional curves_results
* ``metrics_table.csv``  — 2-column ``metric,value``, keys sorted
* ``run_metadata.json/.csv`` — model family/variant/weights/seed/split/
  img size/unclear policy/dataset export + host/runtime info
* ``train_summary.json/.csv`` — wall time + model size stats

``collect_runtime_info`` records torch, CUDA and the card in place of the
JAX keys.
"""

from __future__ import annotations

import csv
import json
import platform
import socket
from pathlib import Path
from typing import Optional

import torch


def save_metrics_json(metrics: dict, out_path: "str | Path") -> Path:
    """Persist a metrics dict as pretty JSON."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(metrics, indent=2))
    return out_path


def save_metrics_table_csv(metrics_dict: dict, out_path: "str | Path") -> Path:
    """2-column ``metric,value`` CSV, keys sorted (ref: yolo.py:310-321).

    Nested values (e.g. curves_results) are skipped — the CSV is the flat
    table view; the JSON carries the full payload.
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["metric", "value"])
        for k in sorted(metrics_dict.keys()):
            v = metrics_dict[k]
            if isinstance(v, (list, dict)):
                continue
            writer.writerow([k, v])
    return out_path


def infer_model_variant_from_weights(weights_name: str) -> str:
    """Weights filename → compact variant label (ref: yolo.py:323-328)."""
    return Path(weights_name).stem


def save_run_metadata_artifacts(
    metadata: dict, out_json_path: "str | Path", out_csv_path: "str | Path"
) -> "tuple[Path, Path]":
    """Run metadata as JSON + 2-column CSV (ref: yolo.py:331-344)."""
    out_json_path = Path(out_json_path)
    out_json_path.parent.mkdir(parents=True, exist_ok=True)
    out_json_path.write_text(json.dumps(metadata, indent=2))
    return out_json_path, save_metrics_table_csv(metadata, out_csv_path)


def save_training_summary(
    *,
    train_wall_time_s: float,
    model_name: str,
    data_yaml: str,
    run_name: str,
    out_json_path: "str | Path",
    out_csv_path: "str | Path",
    params_total: Optional[int] = None,
    params_trainable: Optional[int] = None,
    flops_g: Optional[float] = None,
    extra: Optional[dict] = None,
) -> "tuple[Path, Path]":
    """Training summary JSON + CSV (ref: yolo.py:347-376)."""
    summary = {
        "model_name": model_name,
        "data_yaml": data_yaml,
        "run_name": run_name,
        "train_wall_time_s": float(train_wall_time_s),
        "params_total": params_total,
        "params_trainable": params_trainable,
        "flops_g": flops_g,
    }
    if extra:
        summary.update(extra)
    out_json_path = Path(out_json_path)
    out_json_path.parent.mkdir(parents=True, exist_ok=True)
    out_json_path.write_text(json.dumps(summary, indent=2))
    return out_json_path, save_metrics_table_csv(summary, out_csv_path)


def add_derived_speed_metrics(metrics_dict: dict) -> dict:
    """Derived throughput metrics (ref: scripts/eval_detector.py:99-116)."""

    def _safe(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    pre = _safe(metrics_dict.get("speed_preprocess_ms_per_img"))
    inf = _safe(metrics_dict.get("speed_inference_ms_per_img"))
    post = _safe(metrics_dict.get("speed_postprocess_ms_per_img"))

    if inf is not None and inf > 0:
        metrics_dict["fps_inference_only"] = 1000.0 / inf
    if pre is not None and inf is not None and post is not None:
        total = pre + inf + post
        metrics_dict["speed_total_ms_per_img"] = total
        if total > 0:
            metrics_dict["fps_end_to_end"] = 1000.0 / total
    return metrics_dict


def collect_runtime_info() -> dict:
    """Environment info for reproducibility: the host, torch, CUDA and the
    card (``device_kind`` is ``torch.cuda.get_device_name``; None and a
    ``device_count`` of 0 where there is no card)."""
    cuda = torch.cuda.is_available()
    return {
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
    }
