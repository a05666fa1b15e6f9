"""Training augmentation on the device: HSV jitter and horizontal flip.

Counterpart of ``multimodal_moe_tpu/ops/augment.py`` (the protocol's
photometric + flip bundle; geometric augmentation stays off). Each function
draws its per-image numbers from a ``torch.Generator``, or takes them as
arguments (``dh``, ``gs``, ``gv``, ``flip``), so that a test can feed the
draws JAX made.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0,1] → HSV in [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / maxc.clamp_min(1e-12), torch.zeros_like(maxc))
    safe = rng.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV in [0,1] → RGB in [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sector = torch.stack([i == k for k in range(6)])            # jnp.select's conditions

    def select(*choices):
        out = torch.zeros_like(v)                               # jnp.select's default
        for k in reversed(range(6)):                            # the first true one wins
            out = torch.where(sector[k], choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _uniform(shape, low, high, generator, device):
    on = generator.device if generator is not None else device
    return (torch.rand(shape, generator=generator, device=on) * (high - low) + low).to(device)


def hsv_draws(b: int, generator: "torch.Generator | None", device, *, h_gain: float = 0.015,
              s_gain: float = 0.7, v_gain: float = 0.4) -> "Dict[str, torch.Tensor]":
    """Per-image gains (Ultralytics convention): ``dh`` uniform in ±h_gain,
    ``gs``/``gv`` uniform in 1 ± s_gain / v_gain; each (B, 1, 1)."""
    return {"dh": _uniform((b, 1, 1), -h_gain, h_gain, generator, device),
            "gs": 1.0 + _uniform((b, 1, 1), -s_gain, s_gain, generator, device),
            "gv": 1.0 + _uniform((b, 1, 1), -v_gain, v_gain, generator, device)}


def hsv_jitter(images: torch.Tensor, dh: torch.Tensor, gs: torch.Tensor,
               gv: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0,1]: hue shifted by ``dh`` with wraparound,
    saturation and value scaled by ``gs`` and ``gv`` and clipped."""
    hsv = rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] + dh, 1.0)
    s = (hsv[..., 1] * gs).clamp(0.0, 1.0)
    v = (hsv[..., 2] * gv).clamp(0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def random_hflip(images: torch.Tensor, boxes: torch.Tensor,
                 flip: torch.Tensor) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Per-image horizontal flip (``flip`` (B,) bool) with box mirroring:
    ``x ↦ (w − 1) − x``, as the JAX function does (not ``w − x``)."""
    w = images.shape[2]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    x1, x2 = boxes[..., 0], boxes[..., 2]
    f = flip[:, None]
    new_boxes = torch.stack([torch.where(f, (w - 1) - x2, x1), boxes[..., 1],
                             torch.where(f, (w - 1) - x1, x2), boxes[..., 3]], dim=-1)
    return images, new_boxes


def augment_draws(b: int, generator: "torch.Generator | None", device, *,
                  hflip_prob: float = 0.5) -> "Dict[str, torch.Tensor]":
    """Every draw of :func:`train_augment` for a batch of ``b``."""
    draws = hsv_draws(b, generator, device)
    draws["flip"] = _uniform((b,), 0.0, 1.0, generator, device) < hflip_prob
    return draws


def train_augment(images: torch.Tensor, boxes: torch.Tensor, *,
                  generator: "torch.Generator | None" = None,
                  draws: "Optional[Dict[str, torch.Tensor]]" = None, hsv: bool = True,
                  hflip_prob: float = 0.5) -> "Tuple[torch.Tensor, torch.Tensor]":
    """The protocol-legal bundle: HSV jitter, then horizontal flip. The
    draws come from ``generator`` unless given (keys of
    :func:`augment_draws`)."""
    if draws is None:
        draws = augment_draws(images.shape[0], generator, images.device, hflip_prob=hflip_prob)
    if hsv:
        images = hsv_jitter(images, draws["dh"], draws["gs"], draws["gv"])
    if hflip_prob > 0:
        images, boxes = random_hflip(images, boxes, draws["flip"])
    return images, boxes
