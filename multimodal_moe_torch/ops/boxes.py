"""Box geometry in absolute-pixel xyxy: conversions, area, IoU.

Counterpart of ``multimodal_moe_tpu/ops/boxes.py`` (GIoU for the DETR loss;
CIoU waits for YOLO training). The arithmetic order is the JAX module's,
because NMS decisions at exactly the threshold depend on it:
``inter / ((area_a + area_b) - inter + EPS)``.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` xyxy → center-xywh."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    ctr = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5
    return torch.cat([ctr, wh], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` center-xywh → xyxy."""
    half = boxes[..., 2:4] * 0.5
    return torch.cat([boxes[..., 0:2] - half, boxes[..., 0:2] + half], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` xyxy → area, clamped at zero for degenerate boxes."""
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between ``(..., N, 4)`` and ``(..., M, 4)`` → ``(..., N, M)``."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., 0:2], b[..., 0:2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return inter / (union + EPS)


def elementwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between aligned box arrays ``(..., 4)`` vs ``(..., 4)`` → ``(...)``."""
    lt = torch.maximum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    rb = torch.minimum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes_a) + box_area(boxes_b) - inter
    return inter / (union + EPS)


def elementwise_giou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Generalized IoU (differentiable regression target), aligned ``(..., 4)``."""
    iou = elementwise_iou(boxes_a, boxes_b)
    lt = torch.minimum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    rb = torch.maximum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    enclose = wh[..., 0] * wh[..., 1]
    lt_i = torch.maximum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    rb_i = torch.minimum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    wh_i = (rb_i - lt_i).clamp_min(0.0)
    inter = wh_i[..., 0] * wh_i[..., 1]
    union = box_area(boxes_a) + box_area(boxes_b) - inter
    return iou - (enclose - union) / (enclose + EPS)


def pairwise_giou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """GIoU matrix ``(..., N, M)`` between ``(..., N, 4)`` and ``(..., M, 4)``
    (the DETR Hungarian cost)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return elementwise_giou(a.expand(shape), b.expand(shape))
