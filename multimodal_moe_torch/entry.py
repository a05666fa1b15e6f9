"""Entry point: the flagship detector's forward at the protocol resolution.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``.
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from .models.yolo import YoloDetector

IMG_H, IMG_W = 704, 1248


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(images_u8)`` runs YOLO-s (random
    weights from seed 0) on a uint8 NHWC batch and returns
    ``(boxes (B, A, 4), scores (B, A))``. Runs on ``cuda`` unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    model = YoloDetector(num_classes=1, variant="s", generator=gen).eval().to(dev)

    def fn(images_u8):
        with torch.inference_mode():
            out = model(images_u8.float() / 255.0)
            return out["boxes"], torch.sigmoid(out["cls_logits"][..., 0])

    example_args = (torch.zeros((1, IMG_H, IMG_W, 3), dtype=torch.uint8, device=dev),)
    return fn, example_args
