"""Box-container normalization shared with the exporters.

The port reads the parquet and label files the JAX package's exporters
write; of ``multimodal_moe_tpu/data/exports.py`` it needs only
``safe_iter_boxes``, which the loaders use to read a row's boxes. The file
keeps the JAX module's name so a reader finds its counterpart.
"""

from __future__ import annotations

from typing import List

import numpy as np


def safe_iter_boxes(xyxy_bboxes) -> "List[np.ndarray]":
    """Normalize box containers (ndarray / list / object arrays) into a list
    of ``(4,)`` float arrays; anything else gives no boxes."""
    if xyxy_bboxes is None:
        return []
    arr = np.asarray(xyxy_bboxes)
    if arr.size == 0:
        return []
    if arr.dtype == object:
        out: List[np.ndarray] = []
        for item in xyxy_bboxes:
            item_arr = np.asarray(item, dtype=np.float32)
            if item_arr.shape == (4,):
                out.append(item_arr)
        return out
    if arr.ndim == 2 and arr.shape[1] == 4:
        return [arr[i] for i in range(arr.shape[0])]
    if arr.ndim == 1 and arr.shape[0] == 4:
        return [arr]
    return []
