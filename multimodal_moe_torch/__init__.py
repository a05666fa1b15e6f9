"""PyTorch + CUDA port of ``multimodal_moe_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package imports nothing of it (and
never ``jax``). File names mirror the JAX package: ``models/yolo.py`` here
is the counterpart of ``multimodal_moe_tpu/models/yolo.py``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
