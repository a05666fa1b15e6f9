"""Shared CLI plumbing: the device, read from ``MMOE_PLATFORM`` as the JAX
CLIs read their platform (``scripts/_common.py``): ``cpu`` gives the CPU,
anything else the card."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device


def platform_device() -> "str | None":
    """``"cpu"`` when ``MMOE_PLATFORM=cpu``, else None: the card (on a
    multi-process launch, this rank's card)."""
    return "cpu" if os.environ.get("MMOE_PLATFORM") == "cpu" else None


def cli_device() -> torch.device:
    """The CPU when ``MMOE_PLATFORM=cpu``, else the card (which raises
    where there is none: the port never drops to the CPU on its own)."""
    return resolve_device(platform_device())


def load_resized(path: Path, img_h: int, img_w: int) -> "tuple[np.ndarray, tuple[int, int]]":
    """An image file as uint8 RGB resized (bilinear) to ``img_h`` x ``img_w``,
    with its source (width, height)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        size = im.size
        return np.asarray(im.resize((img_w, img_h), Image.BILINEAR), np.uint8), size
