"""Bounding-box math over the canonical format: absolute-pixel ``[x1,y1,x2,y2]``.

The port's own copy of ``multimodal_moe_tpu/data/bboxes.py``:

* ``points_to_xyxy``  — multipoint → xyxy via min/max, ``None`` on degenerate
* ``xyxy_to_xywh``    — COCO-style top-left xywh (absolute pixels)
* ``xyxy_to_yolo``    — normalized center-xywh, default canvas 1248×704
* ``clamp_xyxy``      — clamp to ``[0, W-1] × [0, H-1]`` (zero-based indices)
* ``is_valid_box``    — min-size quality filter (default 2 px)

The batch forms (``*_batch``) work on ``(..., 4)`` / ``(..., P, 2)`` arrays.
Where JAX's take an ``xp=`` namespace, the port's take a numpy array or a
torch tensor and return the same kind, computing the same expression in the
same order: bitwise JAX's with ``xp=np`` in float32 and float64
(``tests/test_torch_ingest_modules.py``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_IMG_W = 1248
DEFAULT_IMG_H = 704


# ---------------------------------------------------------------------------
# Scalar API (host-side ingestion)
# ---------------------------------------------------------------------------

def points_to_xyxy(points: Iterable) -> Optional[List[float]]:
    """Convert an iterable of ``(x, y)`` points into a canonical xyxy box;
    ``None`` when the enclosing box is degenerate (zero width or height)."""
    pts = np.stack([np.asarray(p, dtype=np.float32) for p in points])
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError("Expected iterable of (x, y) points.")
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    if hi[0] <= lo[0] or hi[1] <= lo[1]:
        return None
    return [float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1])]


def xyxy_to_xywh(box: Sequence[float]) -> List[float]:
    """xyxy → absolute top-left xywh (COCO convention)."""
    x1, y1, x2, y2 = (float(v) for v in box)
    return [x1, y1, x2 - x1, y2 - y1]


def xyxy_to_yolo(
    box: Sequence[float], img_w: int = DEFAULT_IMG_W, img_h: int = DEFAULT_IMG_H
) -> List[float]:
    """xyxy → YOLO normalized center-xywh."""
    x1, y1, x2, y2 = (float(v) for v in box)
    w = x2 - x1
    h = y2 - y1
    return [(x1 + w / 2.0) / img_w, (y1 + h / 2.0) / img_h, w / img_w, h / img_h]


def clamp_xyxy(
    box: Sequence[float], img_w: int = DEFAULT_IMG_W, img_h: int = DEFAULT_IMG_H
) -> List[float]:
    """Clamp a box to valid zero-based pixel indices ``[0, W-1] × [0, H-1]``
    (the maximum valid *pixel index*, not the image extent)."""
    x1, y1, x2, y2 = (float(v) for v in box)
    xmax, ymax = img_w - 1, img_h - 1
    return [
        min(max(x1, 0.0), xmax),
        min(max(y1, 0.0), ymax),
        min(max(x2, 0.0), xmax),
        min(max(y2, 0.0), ymax),
    ]


def is_valid_box(box: Sequence[float], min_size: float = 2.0) -> bool:
    """Quality filter: both sides at least ``min_size`` px."""
    x1, y1, x2, y2 = (float(v) for v in box)
    return (x2 - x1) >= min_size and (y2 - y1) >= min_size


# ---------------------------------------------------------------------------
# Batch API: a numpy array in gives a numpy array out, a tensor a tensor
# ---------------------------------------------------------------------------

def _concat(parts, like):
    if isinstance(like, torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _const(values, like):
    """``values`` as an array of ``like``'s kind, dtype (and device)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(values, dtype=like.dtype, device=like.device)
    return np.asarray(values, dtype=like.dtype)


def _fold(points, keeps):
    """numpy's ``minimum``/``maximum`` reduction over axis -2, point by
    point: the running value stays where it is NaN or ``keeps(acc, x)``,
    else it takes ``x`` (so of two equal zeros the later one's sign wins,
    where ``torch.amin`` keeps the first)."""
    acc = points[..., 0, :]
    for i in range(1, points.shape[-2]):
        x = points[..., i, :]
        acc = torch.where(torch.isnan(acc) | keeps(acc, x), acc, x)
    return acc


def points_to_xyxy_batch(points):
    """``(..., P, 2)`` point sets → ``(..., 4)`` xyxy boxes + validity mask.

    Degenerate boxes (the scalar API's ``None``) come back as a ``False``
    entry in the mask instead of a dynamic-length output."""
    if isinstance(points, torch.Tensor):
        lo = _fold(points[..., 0:2], lambda acc, x: acc < x)
        hi = _fold(points[..., 0:2], lambda acc, x: acc > x)
    else:
        lo = np.min(points[..., 0:2], axis=-2)
        hi = np.max(points[..., 0:2], axis=-2)
    boxes = _concat([lo, hi], points)
    valid = (hi[..., 0] > lo[..., 0]) & (hi[..., 1] > lo[..., 1])
    return boxes, valid


def xyxy_to_xywh_batch(boxes):
    """``(..., 4)`` xyxy → absolute top-left xywh."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return _concat([boxes[..., 0:2], wh], boxes)


def xyxy_to_yolo_batch(boxes, img_w: float = DEFAULT_IMG_W, img_h: float = DEFAULT_IMG_H):
    """``(..., 4)`` xyxy → YOLO normalized center-xywh."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    ctr = boxes[..., 0:2] + wh / 2.0
    scale = _const([img_w, img_h], boxes)
    return _concat([ctr / scale, wh / scale], boxes)


def clamp_xyxy_batch(boxes, img_w: float = DEFAULT_IMG_W, img_h: float = DEFAULT_IMG_H):
    """``(..., 4)`` xyxy clamped to ``[0, W-1] × [0, H-1]``."""
    hi = _const([img_w - 1, img_h - 1, img_w - 1, img_h - 1], boxes)
    if isinstance(boxes, torch.Tensor):
        # np.clip's rule: max(a, lo) = a if isnan(a) or a > lo else lo, then
        # min(.., hi) alike; so NaN stays NaN and -0.0 becomes 0.0
        # (torch.clamp keeps -0.0).
        lo = torch.zeros_like(hi)
        up = torch.where(torch.isnan(boxes) | (boxes > lo), boxes, lo)
        return torch.where(torch.isnan(up) | (up < hi), up, hi)
    return np.clip(boxes, 0.0, hi)


def is_valid_box_batch(boxes, min_size: float = 2.0):
    """``(..., 4)`` xyxy → bool mask of boxes at least ``min_size`` per side."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)
