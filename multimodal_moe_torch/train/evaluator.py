"""Detection evaluator: inference + NMS on the card → COCO metrics + the
time of each stage.

Counterpart of ``multimodal_moe_tpu/train/evaluator.py``. Produces the same
metrics dict (map50 / map50_95 / precision / recall / curves_results /
``speed_*_ms_per_img`` / n_images) from the stages it times:

* preprocess  — host batch, its copy to the card, and the YUV420 → RGB
  conversion of a YUV batch there
* inference   — the forward (and, for a single-class anchor detector, the
  top-k candidate decode)
* postprocess — batched NMS (the keep-mask kernel on the card), or the
  top-``max_det`` selection of the DETR family

Each stage ends with ``torch.cuda.synchronize`` on the card, so its time is
the card's work, not its launches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Mapping

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.flop_counter import FlopCounterMode

from .._device import resolve_device
from ..ops.coco_map import evaluate_detections
from ..ops.nms import batched_nms
from ..ops.preprocess import yuv420_to_rgb_u8
from ..serving import detr_topk_select, topk_candidates


def _in_eval_mode(model: torch.nn.Module, fn: Callable):
    """Run ``fn()`` with ``model`` in eval mode, then restore its mode."""
    was_training = model.training
    model.eval()
    try:
        return fn()
    finally:
        model.train(was_training)


def make_inference_step(
    model: torch.nn.Module,
    *,
    use_sigmoid: bool = True,
    topk_decode: bool = True,
    num_candidates: int = 1024,
    score_threshold: float = 0.001,
):
    """Return ``infer(params, images_u8, context_ids=None) -> (boxes, scores)``.

    ``params`` maps names of ``model.state_dict()`` to tensors (for example
    the EMA parameters with the running statistics); they are applied with
    ``torch.func.functional_call``, and the names it leaves out take the
    model's own tensors. Build it once and reuse it across epochs and
    checkpoints, as the JAX step with ``variables`` as an argument. Images
    go to the device of ``params``; the forward runs in eval mode under
    ``torch.inference_mode``.

    For single-class anchor detectors (the YOLO family) the default
    ``topk_decode`` returns the ``num_candidates``-candidate pool with the
    DFL decode run only on those rows (``serving.topk_candidates``): the
    same NMS result as full decode at the same pool size. ``num_candidates``
    and ``score_threshold`` must match the NMS call downstream (both use the
    ``batched_nms`` defaults)."""
    context_aware = getattr(model, "context_aware", False)

    def infer(params: "Mapping[str, torch.Tensor]", images_u8, context_ids=None):
        device = next(iter(params.values())).device
        with torch.inference_mode():
            images = torch.as_tensor(images_u8, device=device).float() / 255.0
            kwargs = {}
            if context_aware and context_ids is not None:
                kwargs["context_ids"] = torch.as_tensor(context_ids, device=device)
            out = _in_eval_mode(model, lambda: functional_call(
                model, dict(params), (images,), kwargs))
            if (
                topk_decode
                and use_sigmoid
                and "anchor_points" in out
                and out["cls_logits"].shape[-1] == 1
            ):
                return topk_candidates(out, k=num_candidates, score_threshold=score_threshold)
            scores = out["cls_logits"][..., 0]
            if use_sigmoid:
                scores = torch.sigmoid(scores)
            return out["boxes"], scores

    return infer


def make_inference_fn(model: torch.nn.Module, params: "Mapping[str, torch.Tensor]", *,
                      use_sigmoid: bool = True):
    """Forward with fixed ``params``: uint8 images → (boxes, scores) per
    anchor or query. Context-aware models (MoE) take the per-image solar
    bin ids."""
    infer_v = make_inference_step(model, use_sigmoid=use_sigmoid)

    def infer(images_u8, context_ids=None):
        return infer_v(params, images_u8, context_ids)

    return infer


def model_flops_g(model: torch.nn.Module, img_h: int, img_w: int) -> "float | None":
    """Forward FLOPs in GFLOPs for one image, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over a one-image forward on
    the model's device (products and convolutions, a multiply-add as two;
    XLA's count in the JAX package also has the elementwise work). Returns
    None where the count fails or is zero: FLOPs are best-effort metadata."""
    try:
        device = next(model.parameters()).device
        images = torch.zeros((1, img_h, img_w, 3), dtype=torch.float32, device=device)
        counter = FlopCounterMode(display=False)
        with torch.inference_mode(), counter:
            _in_eval_mode(model, lambda: model(images))
        flops = float(counter.get_total_flops())
        return flops / 1e9 if flops > 0 else None
    except Exception:  # best effort, as the JAX cost analysis
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_detector(
    loader: Iterable,
    infer_fn: Callable,
    *,
    iou_threshold: float = 0.7,
    score_threshold: float = 0.001,
    max_det: int = 300,
    gt_from_batch: bool = True,
    compute_curves: bool = True,
    use_nms: bool = True,
    device=None,
) -> "Dict[str, Any]":
    """Run eval over a loader; returns the reference-schema metrics dict.

    ``loader`` yields dicts with ``image`` (B,H,W,3 u8) or the YUV420 planes
    ``y``, ``cb``, ``cr``, and ``gt_boxes``, ``gt_mask``, ``batch_valid``
    and, for context-aware models, ``solar_bin``. Batches go to ``device``
    (the card unless ``device="cpu"``); a YUV batch becomes uint8 RGB there
    (``preprocess.yuv420_to_rgb_u8``). Rows whose ``batch_valid`` is false
    are not scored.
    """
    device = resolve_device(device)
    det_boxes, det_scores, gt_boxes_all = [], [], []
    t_pre = t_inf = t_post = 0.0
    n_images = 0
    t_mark = time.perf_counter()

    def on_device(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(device)

    for batch in loader:
        if "y" in batch:  # store="yuv420" loader: finish the decode on the card
            images = yuv420_to_rgb_u8(on_device(batch["y"]), on_device(batch["cb"]),
                                      on_device(batch["cr"]))
        else:
            images = on_device(batch["image"])
        _sync(device)
        now = time.perf_counter()
        t_pre += now - t_mark
        t_mark = now

        ctx = batch.get("solar_bin")
        boxes, scores = (
            infer_fn(images, on_device(ctx)) if ctx is not None else infer_fn(images)
        )
        _sync(device)
        now = time.perf_counter()
        t_inf += now - t_mark
        t_mark = now

        with torch.inference_mode():
            if use_nms:
                nms = batched_nms(
                    boxes,
                    scores,
                    iou_threshold=iou_threshold,
                    score_threshold=score_threshold,
                    max_det=max_det,
                )
            else:
                # NMS-free (DETR family): top-max_det by score.
                nms = detr_topk_select(boxes, scores, max_det=max_det,
                                       score_threshold=score_threshold)
        _sync(device)
        now = time.perf_counter()
        t_post += now - t_mark

        nms_boxes = nms.boxes.cpu().numpy()
        nms_scores = nms.scores.cpu().numpy()
        nms_valid = nms.valid.cpu().numpy()
        valid_rows = np.asarray(batch.get("batch_valid", np.ones(len(nms_boxes), bool)))
        gtb = np.asarray(batch["gt_boxes"]) if gt_from_batch else None
        gtm = np.asarray(batch["gt_mask"]) if gt_from_batch else None

        for i in range(nms_boxes.shape[0]):
            if not valid_rows[i]:
                continue
            keep = nms_valid[i]
            det_boxes.append(nms_boxes[i][keep])
            det_scores.append(nms_scores[i][keep])
            if gt_from_batch:
                gt_boxes_all.append(gtb[i][gtm[i]])
            n_images += 1
        t_mark = time.perf_counter()

    metrics: "Dict[str, Any]" = {}
    if gt_from_batch and n_images:
        coco = evaluate_detections(
            det_boxes, det_scores, gt_boxes_all, compute_curves=compute_curves
        )
        metrics.update(coco.to_metrics_dict())

    if n_images:
        metrics["speed_preprocess_ms_per_img"] = 1000.0 * t_pre / n_images
        metrics["speed_inference_ms_per_img"] = 1000.0 * t_inf / n_images
        metrics["speed_postprocess_ms_per_img"] = 1000.0 * t_post / n_images
    metrics["n_images"] = n_images
    return metrics


def make_ema_val_fn(
    model: torch.nn.Module,
    make_loader: Callable[[], Iterable],
    *,
    compute_curves: bool = False,
) -> "Callable[[Any], Dict[str, Any]]":
    """``val_fn`` for ``DetectionTrainer.fit``: evaluates a
    ``train.state.TrainState``'s EMA parameters with its model's running
    statistics over a fresh ``make_loader()``, on the state's device, as the
    JAX trainers' scripts do every epoch. ``model`` is the detector the
    state trains or its template (the same architecture); one inference
    step serves every epoch."""
    infer_v = make_inference_step(model)

    def val_fn(state) -> "Dict[str, Any]":
        params = {**dict(state.model.named_buffers()), **state.ema_params}
        return evaluate_detector(
            make_loader(),
            lambda images, context_ids=None: infer_v(params, images, context_ids),
            compute_curves=compute_curves,
            device=next(iter(params.values())).device,
        )

    return val_fn
