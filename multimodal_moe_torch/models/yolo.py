"""YOLO-class detector (PyTorch): CSP/Plain backbone, PAN neck,
anchor-free decoupled head with distribution-focal box regression; fp, or
int8 for serving (``int8=True``, ``int8_fp_box=True``).

Counterpart of ``multimodal_moe_tpu/models/yolo.py``. The public input is
NHWC like the JAX model's; inside, tensors are NCHW, and the head maps are
permuted back to NHWC before they are flattened so that anchors, logits and
boxes come out level-major and row-major exactly as the JAX model orders
them. The int8 model quantizes the images to codes at 1/127 and runs every
conv on int8 codes (``quant.QT``) up to the prediction convs
(:class:`QPredConv`), whose fp32 outputs decode as the fp model's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.int8_conv import int8_conv2d
from ..quant import QT, dequantize, q_from_images
from .layers import (
    AutoNamer,
    CSPStage,
    ConvBNAct,
    PlainStage,
    SPPF,
    SpaceToDepthStem,
    add_auto,
    concat,
    lecun_normal_,
    register_conv_quant,
    upsample2x,
)

# (depth_multiple, width_multiple, max_channels)
VARIANTS: "Dict[str, Tuple[float, float, int]]" = {
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.0, 1.0, 512),
}

BASE_CHANNELS = (64, 128, 256, 512, 1024)
BASE_DEPTHS = (3, 6, 6, 3)
STRIDES = (8, 16, 32)
REG_MAX = 16
CLS_PRIOR_BIAS = -4.6  # sigmoid(-4.6) ≈ 0.01


def _round8(x: float) -> int:
    return max(8, int(round(x / 8)) * 8)


def scaled_channels(variant: str) -> "list[int]":
    d, w, maxc = VARIANTS[variant]
    return [_round8(min(c, maxc) * w) for c in BASE_CHANNELS]


def scaled_depths(variant: str) -> "list[int]":
    d, _, _ = VARIANTS[variant]
    return [max(1, round(n * d)) for n in BASE_DEPTHS]


def _run(module: nn.Module, names: "list[str]", x):
    for name in names:
        x = getattr(module, name)(x)
    return x


class Backbone(nn.Module):
    """Emits the stride 8/16/32 maps (P3, P4, P5). ``arch="tpu"``: space-to-
    depth stem and PlainStages at /4 and /8; ``arch="csp"``: two strided
    convs and CSP at every level."""

    def __init__(self, variant: str = "s", arch: str = "tpu", int8: bool = False):
        super().__init__()
        ch = scaled_channels(variant)
        depths = scaled_depths(variant)
        nm = AutoNamer()
        add = lambda m: add_auto(self, nm, m)  # noqa: E731
        q = dict(int8=int8)
        if arch == "tpu":
            self._to_p3 = [
                add(SpaceToDepthStem(3, ch[1], ratio=4, **q)),          # /4
                add(PlainStage(ch[1], ch[1], depths[0], **q)),
                add(ConvBNAct(ch[1], ch[2], 3, strides=2, **q)),        # /8
                add(PlainStage(ch[2], ch[2], depths[1], **q)),
            ]
        elif arch == "csp":
            self._to_p3 = [
                add(ConvBNAct(3, ch[0], 3, strides=2, **q)),            # /2
                add(ConvBNAct(ch[0], ch[1], 3, strides=2, **q)),        # /4
                add(CSPStage(ch[1], ch[1], depths[0], **q)),
                add(ConvBNAct(ch[1], ch[2], 3, strides=2, **q)),        # /8
                add(CSPStage(ch[2], ch[2], depths[1], **q)),
            ]
        else:
            raise ValueError(f"arch must be 'tpu' or 'csp', got {arch!r}")
        self._to_p4 = [
            add(ConvBNAct(ch[2], ch[3], 3, strides=2, **q)),            # /16
            add(CSPStage(ch[3], ch[3], depths[2], **q)),
        ]
        self._to_p5 = [
            add(ConvBNAct(ch[3], ch[4], 3, strides=2, **q)),            # /32
            add(CSPStage(ch[4], ch[4], depths[3], **q)),
            add(SPPF(ch[4], ch[4], **q)),
        ]

    def forward(self, x):
        p3 = _run(self, self._to_p3, x)
        p4 = _run(self, self._to_p4, p3)
        p5 = _run(self, self._to_p5, p4)
        return [p3, p4, p5]


class PANNeck(nn.Module):
    """Top-down + bottom-up path aggregation over the three levels."""

    def __init__(self, variant: str = "s", arch: str = "tpu", int8: bool = False):
        super().__init__()
        ch = scaled_channels(variant)
        depth = scaled_depths(variant)[3]
        nm = AutoNamer()
        add = lambda m: add_auto(self, nm, m)  # noqa: E731
        kw = dict(shortcut=False, int8=int8)
        self._t4 = add(CSPStage(ch[4] + ch[3], ch[3], depth, **kw))
        if arch == "tpu":
            self._n3 = add(PlainStage(ch[3] + ch[2], ch[2], depth, **kw))
        else:
            self._n3 = add(CSPStage(ch[3] + ch[2], ch[2], depth, **kw))
        self._down3 = add(ConvBNAct(ch[2], ch[2], 3, strides=2, int8=int8))
        self._n4 = add(CSPStage(ch[2] + ch[3], ch[3], depth, **kw))
        self._down4 = add(ConvBNAct(ch[3], ch[3], 3, strides=2, int8=int8))
        self._n5 = add(CSPStage(ch[3] + ch[4], ch[4], depth, **kw))

    def forward(self, feats):
        p3, p4, p5 = feats
        m = lambda name, x: getattr(self, name)(x)  # noqa: E731
        t4 = m(self._t4, concat([upsample2x(p5), p4]))                   # top-down
        n3 = m(self._n3, concat([upsample2x(t4), p3]))
        n4 = m(self._n4, concat([m(self._down3, n3), t4]))               # bottom-up
        n5 = m(self._n5, concat([m(self._down4, n4), p5]))
        return [n3, n4, n5]


class QPredConv(nn.Module):
    """int8 1×1 prediction conv: quantized weights, fp32 output (read by the
    decode and NMS directly, no requant). It takes the place, and the name,
    of the fp ``nn.Conv2d``."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        register_conv_quant(self, cin, features, 1, requant=False)

    def forward(self, x: QT) -> torch.Tensor:
        y32 = int8_conv2d(x.q, self.w_q)
        c = self.s_w.shape[0]
        return y32.float() * (x.s * self.s_w).view(1, c, 1, 1) + self.b.view(1, c, 1, 1)


class DetectHead(nn.Module):
    """Per level, a box branch (4×REG_MAX DFL logits) and a class branch.

    ``int8``: both branches on int8 codes; ``fp_box`` keeps the box branch
    fp on the dequantized features (the strict-IoU accuracy mode)."""

    def __init__(self, num_classes: int = 1, variant: str = "s", int8: bool = False,
                 fp_box: bool = False):
        super().__init__()
        ch = scaled_channels(variant)
        box_ch = max(16, ch[2] // 4, 4 * REG_MAX)
        cls_ch = max(ch[2], min(num_classes, 100))
        self.fp_box = fp_box
        box_q = int8 and not fp_box

        def pred(cin, n, quant):
            return QPredConv(cin, n) if quant else nn.Conv2d(cin, n, 1)

        for i, cin in enumerate(ch[2:5]):
            self.add_module(f"box{i}_conv1", ConvBNAct(cin, box_ch, 3, int8=box_q))
            self.add_module(f"box{i}_conv2", ConvBNAct(box_ch, box_ch, 3, int8=box_q))
            self.add_module(f"box{i}_pred", pred(box_ch, 4 * REG_MAX, box_q))
            self.add_module(f"cls{i}_conv1", ConvBNAct(cin, cls_ch, 3, int8=int8))
            self.add_module(f"cls{i}_conv2", ConvBNAct(cls_ch, cls_ch, 3, int8=int8))
            self.add_module(f"cls{i}_pred", pred(cls_ch, num_classes, int8))

    def forward(self, feats):
        box_out, cls_out = [], []
        for i, f in enumerate(feats):
            fb = dequantize(f) if self.fp_box and isinstance(f, QT) else f
            box_out.append(_run(self, [f"box{i}_conv1", f"box{i}_conv2", f"box{i}_pred"], fb))
            cls_out.append(_run(self, [f"cls{i}_conv1", f"cls{i}_conv2", f"cls{i}_pred"], f))
        return box_out, cls_out


def make_anchors(
    img_h: int, img_w: int, strides: Sequence[int] = STRIDES
) -> "Tuple[np.ndarray, np.ndarray]":
    """Anchor centers (A, 2) in pixels + per-anchor stride (A, 1)."""
    points, stride_list = [], []
    for s in strides:
        h, w = img_h // s, img_w // s
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pts = np.stack([(xs + 0.5) * s, (ys + 0.5) * s], axis=-1).reshape(-1, 2)
        points.append(pts)
        stride_list.append(np.full((pts.shape[0], 1), s, dtype=np.float32))
    return (
        np.concatenate(points).astype(np.float32),
        np.concatenate(stride_list).astype(np.float32),
    )


def _sum16(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 16 as a fixed pairwise tree of elementwise
    adds. A library reduction may pick its summation order from the tensor's
    size; this order is the same for every row count, so decoding A anchors
    and decoding a gathered K of them give bitwise equal rows."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def dfl_expectation(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4*REG_MAX) DFL logits → (..., 4) expected ltrb distances (in
    stride units): exp(x − max), then two weighted sums, in float32."""
    shape = box_logits.shape[:-1] + (4, REG_MAX)
    x = box_logits.reshape(shape).float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
    return _sum16(e * bins) / _sum16(e)


def decode_boxes(
    box_logits: torch.Tensor, anchor_points: torch.Tensor, anchor_strides: torch.Tensor
) -> torch.Tensor:
    """(B, A, 4*REG_MAX) logits + anchors → (B, A, 4) xyxy pixel boxes."""
    ltrb = dfl_expectation(box_logits) * anchor_strides
    x1y1 = anchor_points - ltrb[..., 0:2]
    x2y2 = anchor_points + ltrb[..., 2:4]
    return torch.cat([x1y1, x2y2], dim=-1)


def _flatten_nhwc(m: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) → (B, h·w, C) in NHWC row-major order."""
    b, c = m.shape[:2]
    return m.permute(0, 2, 3, 1).reshape(b, -1, c)


class YoloDetector(nn.Module):
    """Full detector. ``forward(images)`` takes NHWC float images in [0, 1]
    and returns the five-key dict of the JAX model: flattened raw logits
    plus decoded boxes and the anchors.

    ``dtype`` is the compute (and weight) type; logits and boxes come out in
    float32. Weights are initialised as Flax initialises them (LeCun normal
    kernels, zero biases, class prior bias −4.6) from ``generator``.

    ``int8`` builds the PTQ serving model: its quant tensors (zeros and
    ones until ``quant.load_serving`` fills them) replace the trunk's and the
    head's convs; ``int8_fp_box`` keeps the box branch fp. The int8 model is
    float32 outside its int8 convs.
    """

    # Every batch reduction of its training step (BatchNorm, yolo_loss, the
    # MoE routers) is global under parallel.mesh.use_mesh: it trains on a mesh.
    global_batch_reductions = True

    def __init__(self, num_classes: int = 1, variant: str = "s",
                 dtype: torch.dtype = torch.float32, arch: str = "tpu",
                 generator: "torch.Generator | None" = None, int8: bool = False,
                 int8_fp_box: bool = False):
        super().__init__()
        if int8 and dtype != torch.float32:
            raise ValueError("the int8 model keeps dtype float32 (its scales are float32)")
        self.num_classes = num_classes
        self.dtype = dtype
        self.int8 = int8
        self.backbone = Backbone(variant, arch, int8=int8)
        self.neck = PANNeck(variant, arch, int8=int8)
        self.head = DetectHead(num_classes, variant, int8=int8, fp_box=int8 and int8_fp_box)
        self._init_weights(generator)
        self.to(dtype)
        self._anchor_cache: "Dict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = {}

    def _init_weights(self, generator):
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    nn.init.constant_(
                        mod.bias, CLS_PRIOR_BIAS if name.startswith("head.cls") else 0.0
                    )

    def _anchors(self, img_h: int, img_w: int, device: torch.device):
        key = (img_h, img_w, str(device))
        if key not in self._anchor_cache:
            pts, strides = make_anchors(img_h, img_w)
            self._anchor_cache[key] = (
                torch.as_tensor(pts, device=device),
                torch.as_tensor(strides, device=device),
            )
        return self._anchor_cache[key]

    def forward(self, images: torch.Tensor, train: bool = False) -> "Dict[str, torch.Tensor]":
        """``train`` must agree with the module mode (``model.train()`` /
        ``model.eval()``): BatchNorm follows the mode, as Flax's follows
        ``train``."""
        self._check_mode(train)
        return self._head_outputs(self.neck(self.backbone(self._input(images))), images)

    def _input(self, images: torch.Tensor):
        """NHWC images → the trunk's input: NCHW in ``dtype``, or int8 codes."""
        if self.int8:
            return q_from_images(images)
        return images.to(self.dtype).permute(0, 3, 1, 2)

    def _check_mode(self, train) -> None:
        if not isinstance(train, bool):
            raise TypeError(f"train must be a bool, got {type(train).__name__} (pass "
                            "context_ids by keyword)")
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a model in {'train' if self.training else 'eval'} "
                "mode: BatchNorm follows the mode, so call model.train() or model.eval() first"
            )

    def _head_outputs(self, feats, images: torch.Tensor) -> "Dict[str, torch.Tensor]":
        """Head maps → the five-key output dict, for input ``images``."""
        img_h, img_w = images.shape[1:3]
        box_maps, cls_maps = self.head(feats)

        box_flat = [_flatten_nhwc(m) for m in box_maps]
        cls_logits = torch.cat([_flatten_nhwc(m) for m in cls_maps], dim=1)
        anchor_points, anchor_strides = self._anchors(img_h, img_w, images.device)
        # Decode per level, then concatenate, as the JAX model does.
        lvl_boxes = []
        off = 0
        for lg in box_flat:
            n = lg.shape[1]
            lvl_boxes.append(
                decode_boxes(lg, anchor_points[off:off + n], anchor_strides[off:off + n])
            )
            off += n
        return {
            "box_logits": torch.cat(box_flat, dim=1).float(),   # (B, A, 64)
            "cls_logits": cls_logits.float(),                  # (B, A, nc)
            "boxes": torch.cat(lvl_boxes, dim=1),              # (B, A, 4) xyxy px
            "anchor_points": anchor_points,                    # (A, 2)
            "anchor_strides": anchor_strides,                  # (A, 1)
        }
