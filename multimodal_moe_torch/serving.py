"""Serving path: uint8 NHWC images → fixed-shape :class:`NmsResult`.

Counterpart of ``multimodal_moe_tpu/serving.py``. One step divides by 255,
runs the detector, applies a float32 sigmoid to the class logits and runs
batched NMS (the CUDA keep-mask kernel on the card). ``tail="topk"``
decodes only the top-``pool`` anchors (single class), with results
bitwise equal to the full tail. Under a profiler a step is the span
``serve.step``, with ``serve.forward`` and ``serve.tail`` inside
(``utils.profiler.annotate``).
"""

from __future__ import annotations

import torch

from ._device import model_device
from .models.yolo import decode_boxes
from .ops.nms import NEG_INF, NmsResult, batched_nms, stable_topk
from .utils.profiler import annotate


def topk_candidates(
    out: dict, *, k: int = 512, score_threshold: float = 0.001
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Model outputs → (boxes (B,K,4), scores (B,K)), DFL-decoding only the
    top-k anchors by class score. Scores at or below ``score_threshold``
    come out as ``NEG_INF``, which :func:`batched_nms` masks as the full
    path does."""
    cls_logits = out["cls_logits"]
    if cls_logits.shape[-1] != 1:
        raise ValueError(
            "topk_candidates is single-class (protocol); got "
            f"{cls_logits.shape[-1]} classes"
        )
    scores = torch.sigmoid(cls_logits[..., 0].float())
    masked = torch.where(scores > score_threshold, scores, NEG_INF)
    k = min(k, masked.shape[-1])
    top_scores, top_idx = stable_topk(masked, k)
    box_logits = torch.gather(
        out["box_logits"], 1, top_idx[..., None].expand(-1, -1, out["box_logits"].shape[-1])
    )
    points = out["anchor_points"][top_idx]      # (B, K, 2)
    strides = out["anchor_strides"][top_idx]    # (B, K, 1)
    return decode_boxes(box_logits, points, strides), top_scores


def yolo_serving_nms(
    out: dict,
    *,
    k: int = 512,
    iou_threshold: float = 0.7,
    score_threshold: float = 0.001,
    max_det: int = 300,
    early_exit: bool = False,
) -> NmsResult:
    """Top-k candidate decode + batched NMS; the same result as
    ``batched_nms(out['boxes'], sigmoid(cls), num_candidates=k)``."""
    boxes, scores = topk_candidates(out, k=k, score_threshold=score_threshold)
    return batched_nms(
        boxes, scores,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, num_candidates=k, early_exit=early_exit,
    )


def detr_topk_select(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    *,
    max_det: int = 300,
    score_threshold: float = 0.001,
) -> NmsResult:
    """NMS-free selection for the DETR family: per image, the top
    ``max_det`` queries by score."""
    k = min(max_det, scores.shape[-1])
    top_scores, top_idx = stable_topk(scores, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    valid = top_scores > score_threshold
    return NmsResult(
        torch.where(valid[..., None], top_boxes, 0.0),
        torch.where(valid, top_scores, 0.0),
        torch.where(valid, 0, -1).to(torch.int32),
        valid,
    )


def make_serving_step(
    model,
    *,
    pool: int = 512,
    iou_threshold: float = 0.7,
    score_threshold: float = 0.001,
    max_det: int = 300,
    early_exit: bool = False,
    tail: str = "full",
):
    """Return ``step(images_u8, context_ids=None) -> NmsResult``.

    ``images_u8`` is ``(B, H, W, 3)`` uint8 (a tensor or an array); it is
    moved to the model's device. Anchor detectors take full decode + NMS
    (``tail="full"``) or decode-after-top-k (``tail="topk"``, single class);
    a model without ``anchor_points`` in its outputs takes the DETR top-k.
    """
    if tail not in ("full", "topk"):
        raise ValueError(f"tail must be 'full' or 'topk', got {tail!r}")
    context_aware = getattr(model, "context_aware", False)
    device = model_device(model)
    nms_kw = dict(
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, early_exit=early_exit,
    )

    def step(images_u8, context_ids=None) -> NmsResult:
        with torch.inference_mode(), annotate("serve.step"):
            with annotate("serve.forward"):
                images = torch.as_tensor(images_u8, device=device).float() / 255.0
                kwargs = {}
                if context_aware and context_ids is not None:
                    kwargs["context_ids"] = torch.as_tensor(context_ids, device=device)
                out = model(images, **kwargs)
            with annotate("serve.tail"):
                if "anchor_points" not in out:
                    scores = torch.sigmoid(out["cls_logits"][..., 0].float())
                    return detr_topk_select(
                        out["boxes"], scores,
                        max_det=max_det, score_threshold=score_threshold,
                    )
                if out["cls_logits"].shape[-1] == 1 and tail == "topk":
                    return yolo_serving_nms(out, k=pool, **nms_kw)
                scores = torch.sigmoid(out["cls_logits"][..., 0].float())
                return batched_nms(out["boxes"], scores, num_candidates=pool, **nms_kw)

    return step
