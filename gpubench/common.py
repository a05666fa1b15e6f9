"""What every driver shares: finding a cell and its configuration by name,
the seeded weights and frames made on the device, the port's model built
around them, the profiler's reduction and the table of peaks.

Nothing here imports the port at module level; :func:`build_model` imports
it when a driver asks for the system under test.
"""

from __future__ import annotations

import contextlib
import json
import math
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def load_json(kind: str, name: str) -> dict:
    """``gpubench/<kind>/<name>.json``: a cell or a configuration."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def product_precision(cell: dict) -> str:
    """The peak that bounds the cell's products: bf16 for a bf16 model;
    for float32 under torch's defaults cuDNN's convolutions run in TF32."""
    return {"bf16": "bf16", "fp32_tf32_defaults": "tf32"}[cell["precision"]]


def torch_dtype(cell: dict) -> torch.dtype:
    return torch.bfloat16 if cell["precision"] == "bf16" else torch.float32


# -- the system under test ----------------------------------------------------
def _meta_model(config: dict, dtype: torch.dtype):
    """The port's detector for ``config`` on the ``meta`` device."""
    from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector
    from multimodal_moe_torch.models.yolo import YoloDetector

    kw = dict(num_classes=config["num_classes"], variant=config["variant"], dtype=dtype,
              arch=config["arch"])
    with torch.device("meta"):
        if config.get("num_experts"):
            return MoEYoloDetector(num_experts=config["num_experts"], k=config["top_k"],
                                   capacity_factor=config["capacity_factor"],
                                   dispatch=config["dispatch"], **kw)
        return YoloDetector(**kw)


def build_model(config: dict, dtype: torch.dtype, device, weights: dict, *,
                train: bool = False):
    """The port's detector, its tensors allocated on ``device`` without
    their own initialisation and loaded strictly from ``weights``."""
    model = _meta_model(config, dtype).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.train(train)


def weight_shapes(config: dict, dtype: torch.dtype) -> dict:
    """name → (shape, dtype) of every tensor of the port's state dict."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in _meta_model(config, dtype).state_dict().items()}


# -- inputs from the seed ------------------------------------------------------
def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run."""
    return torch.Generator(device=device).manual_seed(int(seed) * 16 + stream)


def _scale(name: str, shape: tuple) -> "tuple[float, float]":
    """(mean, std) of a tensor's seeded values, by its name: LeCun-normal
    kernels, BatchNorm near identity (:func:`fit_to_frames` then fits its
    statistics and the class prior to the frames);
    router kernels wide enough to decide, context biases that move the
    routing."""
    if name.endswith("num_batches_tracked"):
        return 0.0, 0.0
    if name.endswith(("conv.weight", "_pred.weight")):
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith(".bn.weight"):
        return 1.0, 0.1
    if name.endswith((".bn.bias", "running_mean")):
        return 0.0, 0.1
    if name.endswith("running_var"):
        return 1.0, 0.1
    if name.endswith("_pred.bias"):
        return 0.0, 0.0
    if name.endswith(("experts_w1", "experts_w2", "router_kernel")):
        return 0.0, 1.0 / math.sqrt(shape[-2])
    if name.endswith(("experts_b1", "experts_b2")):
        return 0.0, 0.02
    if name.endswith("context_bias"):
        return 0.0, 0.5
    raise KeyError(f"no rule for the weights of {name}")


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Every tensor of the state dict from one normal draw on ``device``
    (values clipped at ±2σ), scaled by :func:`_scale`, in the type it is
    served in."""
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.empty(total, device=device).normal_(generator=generator(seed, device, 0))
    flat.clamp_(-2.0, 2.0)
    out, off = {}, 0
    for name, (shape, dtype) in shapes.items():
        n = math.prod(shape)
        mean, std = _scale(name, shape)
        t = flat[off:off + n].view(shape) * std + mean
        if name.endswith("running_var"):
            t = t.abs()
        out[name] = t.to(dtype)
        off += n
    return out


def fit_to_frames(weights: dict, config: dict, frames: torch.Tensor, bins=None, *,
                  conf: float = 0.25, anchors_above: int = 20) -> None:
    """Fit the seeded weights to the pool's frames, in place, as a trained
    detector would sit on them: every BatchNorm's running statistics become
    its batch statistics on ``frames`` (so that in eval mode each layer
    passes on unit-scale activations and the outputs follow the image), and
    the class prior (the bias of every ``head.cls*_pred``) is set so that
    the ``anchors_above``-th highest score of an image sits at ``conf`` on
    average: a handful of detections an image clear the server's
    confidence. The float32 reference computes both (TF32 off)."""
    from .reference import detector

    w32 = {k: v.float() for k, v in weights.items()}
    stats: dict = {}
    with torch.no_grad(), reference_precision():
        detector.forward(w32, config, frames, bins, train=True, batch_stats=stats)
        for name, (mean, var) in stats.items():
            for key, value in ((f"{name}.running_mean", mean), (f"{name}.running_var", var)):
                w32[key] = value
                weights[key].copy_(value)
        prior_names = [k for k in weights if k.startswith("head.cls") and k.endswith("_pred.bias")]
        for k in prior_names:
            w32[k] = torch.zeros_like(w32[k])
        logits = detector.forward(w32, config, frames, bins)["cls_logits"][..., 0]
    kth = torch.topk(logits, anchors_above, dim=1).values[:, -1].mean()
    prior = math.log(conf / (1.0 - conf)) - float(kth)
    for k in prior_names:
        weights[k].fill_(prior)


def make_frames(n: int, h: int, w: int, seed: int, device, stream: int = 1,
                chunk: int = 32) -> torch.Tensor:
    """``n`` distinct smooth uint8 NHWC frames: coarse structure at 1/16 of
    the size, detail at 1/4, about mid-grey with a wide spread."""
    gen = generator(seed, device, stream)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        coarse = torch.randn((m, 3, max(1, h // 16), max(1, w // 16)), generator=gen,
                             device=device)
        fine = torch.randn((m, 3, max(1, h // 4), max(1, w // 4)), generator=gen, device=device)
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                              align_corners=False)
        img += 0.4 * torch.nn.functional.interpolate(fine, size=(h, w), mode="bilinear",
                                                     align_corners=False)
        out[s:s + m] = (128.0 + 60.0 * img).clamp(0, 255).round().to(torch.uint8) \
            .permute(0, 2, 3, 1)
    return out


def make_bins(n: int, num_bins: int, seed: int, device, stream: int = 2) -> torch.Tensor:
    return torch.randint(0, num_bins, (n,), generator=generator(seed, device, stream),
                         device=device, dtype=torch.int32)


# -- the profiler's trace -------------------------------------------------------
def device_events(prof) -> list:
    """(name, start_us, end_us) of every operation that ran on the device."""
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def host_events(prof) -> list:
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def merged(intervals: list) -> list:
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, span_us: "tuple[float, float] | None" = None) -> dict:
    """Busy seconds (the union of device operations), the device
    operations that took most time, and the longest idle gaps named by the
    innermost host operation running when each began."""
    dev = device_events(prof)
    if span_us is not None:
        lo, hi = span_us
        dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = merged([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = host_events(prof)
    named = []
    for s, e in gaps:
        inner = [h for h in host if h[1] <= s < h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner else "(no host operation)"
        named.append([name, (e - s) / 1e6])
    return {"busy_s": busy_us / 1e6, "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": named, "events": dev}


@contextlib.contextmanager
def reference_precision():
    """float32 products with TF32 off, for the reference; the defaults come back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_ground_truth(n: int, slots: int, h: int, w: int, seed: int, device,
                      stream: int = 3, max_count: int = 40) -> dict:
    """Padded pedestrian boxes for ``n`` frames: a count in [1, max_count]
    a frame, then boxes 8–160 px wide, 1.5–3 times as tall, anywhere in
    the frame (clipped to it); labels 0."""
    gen = generator(seed, device, stream)
    count = torch.randint(1, max_count + 1, (n, 1), generator=gen, device=device)
    u = torch.rand((n, slots, 4), generator=gen, device=device)
    bw = torch.exp(math.log(8.0) + u[..., 2] * math.log(20.0))
    bh = bw * (1.5 + 1.5 * u[..., 3])
    cx, cy = u[..., 0] * w, u[..., 1] * h
    boxes = torch.stack([(cx - bw / 2).clamp(0, w - 1), (cy - bh / 2).clamp(0, h - 1),
                         (cx + bw / 2).clamp(1, w), (cy + bh / 2).clamp(1, h)], -1)
    mask = torch.arange(slots, device=device)[None] < count
    return {"gt_boxes": torch.where(mask[..., None], boxes, 0.0),
            "gt_labels": torch.zeros((n, slots), dtype=torch.int32, device=device),
            "gt_mask": mask}
