"""Plain reference of the protocol's training step for the YOLO family:
``/255``, HSV jitter and horizontal flip on draws from the trainer's
seeding rule, the forward in train mode (batch statistics), the detection
loss plus the MoE auxiliary loss, autograd's gradients, then optax's chain
as the protocol states it: ``clip_by_global_norm(10)``, decoupled weight
decay on the kernels of rank above 1, SGD with Nesterov momentum under the
warmup-then-linear schedule (the first update has lr 0), and the EMA of
the parameters with its ``0.9999·(1 − exp(−step/2000))`` ramp.

It imports nothing of the port. The augmentation's colour arithmetic is a
frozen copy of the repository's.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from . import detector, tal

GRAD_CLIP = 10.0


def rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / maxc.clamp_min(1e-12), torch.zeros_like(maxc))
    safe = rng.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    sector = torch.stack([i == k for k in range(6)])

    def select(*choices):
        out = torch.zeros_like(v)
        for k in reversed(range(6)):
            out = torch.where(sector[k], choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def augment_draws(b: int, generator: torch.Generator, device) -> dict:
    """dh ∈ ±0.015, gs ∈ 1 ± 0.7, gv ∈ 1 ± 0.4 (each (B, 1, 1)), then the
    flip at probability 0.5, in that order from one generator."""
    def uniform(shape, lo, hi):
        return (torch.rand(shape, generator=generator, device=generator.device)
                * (hi - lo) + lo).to(device)
    d = {"dh": uniform((b, 1, 1), -0.015, 0.015),
         "gs": 1.0 + uniform((b, 1, 1), -0.7, 0.7),
         "gv": 1.0 + uniform((b, 1, 1), -0.4, 0.4)}
    d["flip"] = uniform((b,), 0.0, 1.0) < 0.5
    return d


def augment(images, boxes, d):
    hsv = rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] + d["dh"], 1.0)
    s = (hsv[..., 1] * d["gs"]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * d["gv"]).clamp(0.0, 1.0)
    images = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    w = images.shape[2]
    f = d["flip"]
    images = torch.where(f[:, None, None, None], images.flip(2), images)
    x1, x2 = boxes[..., 0], boxes[..., 2]
    boxes = torch.stack([torch.where(f[:, None], (w - 1) - x2, x1), boxes[..., 1],
                         torch.where(f[:, None], (w - 1) - x1, x2), boxes[..., 3]], dim=-1)
    return images, boxes


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The trainer's rule for a step's augmentation draws."""
    return torch.Generator(device=device).manual_seed(((seed + 7919) << 32) + 2 * step)


_DECAYED = re.compile(r"(\.conv\.weight|_pred\.weight|router_kernel)$")


def decayed(name: str, t: torch.Tensor) -> bool:
    """Weight decay reaches convolution and router kernels of rank above 1."""
    return bool(_DECAYED.search(name)) and t.dim() > 1


def lr_at(count: int, lr0: float, lrf: float, warmup: int, total: int) -> float:
    """Linear warmup from 0, then linear decay to ``lr0·lrf``, in float32."""
    f32 = np.float32
    warmup = max(1, min(warmup, max(total - 1, 1)))

    def linear(init, end, steps, c):
        c = min(max(c, 0), steps)
        return float((f32(init) - f32(end)) * (f32(1) - f32(c) / f32(steps)) + f32(end))

    if count < warmup:
        return linear(0.0, lr0, warmup, count)
    return linear(lr0, lr0 * lrf, max(total - warmup, 1), count - warmup)


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict, batches: list, *, hp: dict,
                draw_seed: int, prec: "detector.Prec | None" = None) -> dict:
    """Run ``len(batches)`` steps from ``weights``. Each batch is a dict of
    ``image`` (B, H, W, 3) uint8, ``gt_boxes``, ``gt_labels``, ``gt_mask``
    and ``solar_bin``. Returns each step's loss, the first step's gradient
    as the optimizer takes it (after the clip), and every parameter's change
    and its EMA's change over the steps, float32, by name, and the first
    step's class logits and boxes."""
    names = [k for k in weights if is_param(k)]
    params = {k: weights[k].detach().float().clone().requires_grad_(True) for k in names}
    start = {k: p.detach().clone() for k, p in params.items()}
    trace = {k: torch.zeros_like(p) for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    losses, first_grad, first_outputs = [], None, None
    f32 = np.float32
    for step, batch in enumerate(batches):
        gen = step_generator(draw_seed, step, batch["image"].device)
        draws = augment_draws(batch["image"].shape[0], gen, batch["image"].device)
        x = batch["image"].float() / 255.0
        images, gt_boxes = augment(x, batch["gt_boxes"], draws)
        wts = dict(weights)
        wts.update(params)
        out = detector.forward_float(wts, cfg, images, batch.get("solar_bin"), train=True,
                                     prec=prec)
        if first_outputs is None:
            first_outputs = (out["cls_logits"].detach(), out["boxes"].detach())
        total, _ = tal.yolo_loss(out, batch["gt_labels"], gt_boxes, batch["gt_mask"])
        if "moe_aux_loss" in out:
            total = total + out["moe_aux_loss"]
        grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k])).detach()
                 for k, g in zip(names, grads)}
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            if not bool(norm < GRAD_CLIP):
                grads = {k: g / norm * GRAD_CLIP for k, g in grads.items()}
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
            lr = lr_at(step, hp["lr0"], hp["lrf"], hp["warmup_steps"], hp["total_steps"])
            for k in names:
                p, g = params[k], grads[k]
                if decayed(k, p):
                    g = g + p * hp["weight_decay"]
                trace[k] = trace[k] * hp["momentum"] + g
                u = g + trace[k] * hp["momentum"]
                p.add_(u * -lr)
            decay = f32(0.9999) * (f32(1) - np.exp(-f32(step + 1) / f32(2000.0)))
            keep, take = float(decay), float(f32(1) - decay)
            for k in names:
                ema[k] = ema[k] * keep + params[k].detach() * take
    return {"losses": losses, "first_grad": first_grad, "first_outputs": first_outputs,
            "delta": {k: (params[k].detach() - start[k]) for k in names},
            "ema_delta": {k: ema[k] - start[k] for k in names}}
