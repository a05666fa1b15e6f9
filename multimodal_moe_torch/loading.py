"""Model and checkpoint loading for inference.

Counterpart of ``multimodal_moe_tpu/loading.py`` for the port's own run
directories: ``model_config.json`` plus the ``torch.save`` checkpoints of
``train/state.py:CheckpointManager`` (``weights/best``, ``weights/last``).
This module is the one place that maps them back to a constructed detector
and its restored weights, fp or, through :func:`quantize_loaded`, int8 PTQ
for serving (YOLO, MoE-YOLO and RT-DETR). A run dir of the JAX package
(Orbax checkpoints) is read after ``tools/orbax_to_torch.py`` has converted
it to this layout.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import torch

from ._device import model_device


def resolve_checkpoint(weights: Path, which: str = "best") -> "Tuple[Path, dict]":
    """Accept a run dir, a weights dir, or a checkpoint dir; return the
    checkpoint path plus the nearest ``model_config.json`` (searched at the
    given dir and up to two parents — the run layout puts it beside
    ``weights/``)."""
    weights = Path(weights)
    cfg: Dict[str, Any] = {}
    for probe in (weights, weights.parent, weights.parent.parent):
        mc = probe / "model_config.json"
        if mc.exists():
            cfg = json.loads(mc.read_text())
            break
    if (weights / "weights" / which).exists():
        return weights / "weights" / which, cfg
    if (weights / which).exists():
        return weights / which, cfg
    return weights, cfg


def build_detector(model_cfg: dict, *, int8: bool = False, fp_box: bool = False):
    """``model_config.json`` → (family, constructed detector), with the JAX
    module's keys and defaults. The weights are a fresh init; an ``int8``
    model's quant tensors are zeros and ones until ``quant.load_serving``.

    ``fp_box`` (yolo/moe int8 only) keeps the DFL box-regression branch fp —
    the strict-IoU PTQ accuracy mode (``models.yolo.DetectHead``)."""
    family = model_cfg.get("family", "yolo")
    num_classes = model_cfg.get("num_classes", 1)
    variant = model_cfg.get("variant", "s")
    extra = {"int8": True} if int8 else {}
    if int8 and fp_box and family != "rtdetr":
        extra["int8_fp_box"] = True
    if family == "moe":
        from .models.moe_yolo import MoEYoloDetector

        return family, MoEYoloDetector(
            num_classes=num_classes, variant=variant,
            num_experts=model_cfg.get("num_experts", 4), **extra,
        )
    if family == "rtdetr":
        from .models.rtdetr import RTDETRDetector

        return family, RTDETRDetector(
            num_classes=num_classes,
            hidden_dim=model_cfg.get("hidden_dim", 256),
            num_queries=model_cfg.get("num_queries", 300),
            num_decoder_layers=model_cfg.get("num_decoder_layers", 6), **extra,
        )
    from .models.yolo import YoloDetector

    return "yolo", YoloDetector(num_classes=num_classes, variant=variant, **extra)


@dataclass
class LoadedDetector:
    """A restored detector: ``model`` on its device in eval mode, holding the
    loaded parameters; ``variables`` the same tensors by name (parameters
    and running statistics), for ``evaluator.make_inference_step``."""

    family: str
    model: Any
    model_cfg: Dict[str, Any]
    variables: Dict[str, torch.Tensor]
    ckpt_path: Path


def load_detector(
    weights,
    *,
    checkpoint: str = "best",
    img_h: int = 704,
    img_w: int = 1248,
    use_ema: bool = True,
    device=None,
) -> LoadedDetector:
    """Run dir → restored model on ``device`` (the card unless
    ``device="cpu"``). EMA parameters by default (the protocol's eval
    channel), with the checkpoint's running statistics."""
    from .train.detection import DetTrainConfig, DetectionTrainer
    from .train.state import CheckpointManager

    ckpt_path, model_cfg = resolve_checkpoint(Path(weights).resolve(), checkpoint)
    family, model = build_detector(model_cfg)
    trainer = DetectionTrainer(
        model,
        DetTrainConfig(
            variant=model_cfg.get("variant", "s"),
            img_h=img_h, img_w=img_w,
            optimizer=model_cfg.get("optimizer", "sgd"),
        ),
        steps_per_epoch=1,
        device=device,
    )
    state = CheckpointManager(ckpt_path.parent).restore_eval(
        ckpt_path.name, trainer.init_state()
    )
    model = state.model.eval()
    if use_ema:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema_params[name])
    variables = dict(model.state_dict())
    return LoadedDetector(family, model, model_cfg, variables, ckpt_path)


def quantize_loaded(
    loaded: LoadedDetector,
    calib_batches: Iterable,
    *,
    fp_box: bool = False,
    mode: str = "absmax",
) -> LoadedDetector:
    """int8 PTQ serving twin of a loaded detector, on its device.

    Reuses a quant npz beside the checkpoint when there is one
    (``int8_quant.npz``, or ``int8_quant_<ckpt>.npz`` as the eval CLI names
    it, in JAX's or the port's writing); else calibrates ``loaded.model``
    on ``calib_batches`` (normalized float NHWC image batches, the
    ``quant.calibrate`` contract) and writes ``int8_quant_<ckpt>.npz``, as
    the eval CLI does. The npz is always the full-int8 model's tree (a
    superset), shared by both serving modes. MoE-YOLO, RT-DETR and the
    ``fp_box`` mode quantize part of the net: their fp islands keep the
    loaded fp weights."""
    from . import quant as qz

    ckpt_dir, ckpt_name = loaded.ckpt_path.parent, loaded.ckpt_path.name
    _, model_q = build_detector(loaded.model_cfg, int8=True)
    qvars = None
    for name in ("int8_quant.npz", f"int8_quant_{ckpt_name}.npz"):
        if (ckpt_dir / name).exists():
            qvars = qz.load_quant_npz(ckpt_dir / name)
            break
    if qvars is None:
        qvars = qz.quantize_detector(loaded.model, model_q, list(calib_batches), mode=mode)
        qz.save_quant_npz(ckpt_dir / f"int8_quant_{ckpt_name}.npz", qvars)
    model_serve = model_q
    if fp_box and loaded.family in ("moe", "yolo"):
        _, model_serve = build_detector(loaded.model_cfg, int8=True, fp_box=True)
    qz.load_serving(model_serve, qz.merge_serving_variables(qvars, loaded.variables))
    model_serve = model_serve.to(model_device(loaded.model)).eval()
    return LoadedDetector(loaded.family, model_serve, loaded.model_cfg,
                          dict(model_serve.state_dict()), loaded.ckpt_path)
