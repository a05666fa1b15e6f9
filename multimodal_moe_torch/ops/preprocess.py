"""Device-side image preprocessing: YUV420 planes to RGB on the card.

Counterpart of ``multimodal_moe_tpu/ops/preprocess.py``. The host decodes
JPEG entropy data to raw YCbCr 4:2:0 planes (no chroma upsample, no colour
conversion); these functions finish the job where the tensors lie: chroma
upsample, YCbCr→RGB (BT.601 full range, the JFIF convention),
normalisation. The arithmetic is the JAX module's, in the same order.
"""

from __future__ import annotations

import torch


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w) → (B, 2h, 2w) nearest-neighbour (broadcast and reshape)."""
    b, h, w = x.shape
    return x[:, :, None, :, None].expand(b, h, 2, w, 2).reshape(b, h * 2, w * 2)


def yuv420_to_rgb(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, *, dtype=torch.float32
) -> torch.Tensor:
    """Raw 4:2:0 planes (uint8) → (B, H, W, 3) RGB in [0, 255] float.

    BT.601 full-range as used by JFIF/libjpeg:
        R = Y + 1.402 (Cr−128)
        G = Y − 0.344136 (Cb−128) − 0.714136 (Cr−128)
        B = Y + 1.772 (Cb−128)
    Chroma is upsampled nearest-neighbour.
    """
    yf = y.to(dtype)
    cbf = upsample2x_nearest(cb.to(dtype)) - 128.0
    crf = upsample2x_nearest(cr.to(dtype)) - 128.0
    r = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def yuv420_to_model_input(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Planes → normalised (B, H, W, 3) float32 in [0, 1] (model input)."""
    return yuv420_to_rgb(y, cb, cr) / 255.0


def yuv420_to_rgb_u8(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Planes → (B, H, W, 3) uint8 RGB: clipped, rounded half to even, as
    the JAX module quantises."""
    return torch.round(yuv420_to_rgb(y, cb, cr)).clamp(0, 255).to(torch.uint8)


def normalize_images_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → float32 in [0, 1] (RGB path)."""
    return images_u8.to(torch.float32) / 255.0


def imagenet_normalize(images_01: torch.Tensor) -> torch.Tensor:
    """Standard ImageNet mean/std (the classification baseline)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=images_01.dtype, device=images_01.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=images_01.dtype, device=images_01.device)
    return (images_01 - mean) / std
