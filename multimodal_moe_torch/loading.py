"""Model and checkpoint loading for inference.

Counterpart of ``multimodal_moe_tpu/loading.py`` for the port's own run
directories: ``model_config.json`` plus the ``torch.save`` checkpoints of
``train/state.py:CheckpointManager`` (``weights/best``, ``weights/last``).
This module is the one place that maps them back to a constructed detector
and its restored weights. Floating point only: int8 serving
(``quantize_loaded``) and Orbax run dirs of the JAX package are not ported
yet (ROADMAP A3, A5).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Tuple

import torch


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
    module's keys and defaults. The weights are a fresh init."""
    if int8 or fp_box:
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP A3: quant.py and the int8 branches)")
    family = model_cfg.get("family", "yolo")
    num_classes = model_cfg.get("num_classes", 1)
    variant = model_cfg.get("variant", "s")
    if family == "moe":
        from .models.moe_yolo import MoEYoloDetector

        return family, MoEYoloDetector(
            num_classes=num_classes, variant=variant,
            num_experts=model_cfg.get("num_experts", 4),
        )
    if family == "rtdetr":
        from .models.rtdetr import RTDETRDetector

        return family, RTDETRDetector(
            num_classes=num_classes,
            hidden_dim=model_cfg.get("hidden_dim", 256),
            num_queries=model_cfg.get("num_queries", 300),
            num_decoder_layers=model_cfg.get("num_decoder_layers", 6),
        )
    from .models.yolo import YoloDetector

    return "yolo", YoloDetector(num_classes=num_classes, variant=variant)


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
