"""Device selection shared by the port's entry points."""

from __future__ import annotations

import itertools

import torch


def model_device(model: torch.nn.Module) -> torch.device:
    """The device of a model's tensors (an int8 YOLO holds buffers only)."""
    return next(itertools.chain(model.parameters(), model.buffers())).device


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a usable card raises:
    the port never drops to the CPU on its own; a caller that wants the CPU
    (the tests) passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
