"""ResNet (PyTorch, NCHW): the -vd trunk, fp and int8, as RT-DETR's
detection backbone (deep 3-conv stem, bottleneck stages with the avg-pool
shortcut), and the vanilla fp classifier of the classification baseline
(7×7 stem, strided 1×1 shortcut, mean pool and ``Dense`` head).

Counterpart of ``multimodal_moe_tpu/models/resnet.py``. Submodules carry the
Flax names (``_ConvBN_0``, ``Conv_0``, ``BatchNorm_0``,
``BottleneckBlock_{i}``). This family's BatchNorm is eps 1e-5 with ReLU, not
the eps 1e-3 / SiLU of ``layers.ConvBNAct``. ``remat=True`` recomputes each
bottleneck block during backward (``torch.utils.checkpoint``, the JAX
model's ``nn.remat``); the recompute leaves the running statistics alone.
With ``int8=True`` the blocks run on ``quant.QT`` codes: the folded convs with
a ReLU epilogue, the residual add requantized to ``s_add_0``, the shortcut's
average pool on the codes in fp32 (rounded back half to even at the
unchanged scale) and the stem's max-pool on the codes. The class's defaults
are the backbone (``vd=True, num_classes=None``); :func:`resnet50` and
:func:`resnet18` take the JAX functions' signatures (the vanilla classifier
of 1000 classes unless asked otherwise).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..quant import QT, max_pool_codes, record_absmax, register_quant
from .layers import (FlaxBatchNorm2d, conv_quant, lecun_normal_, register_conv_quant,
                     remat_active, requant_add, run_block)

BN_EPS = 1e-5


class _ConvBN(nn.Module):
    """Conv (symmetric padding k//2, no bias) → BatchNorm → ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, strides: int = 1,
                 act: bool = True, int8: bool = False):
        super().__init__()
        self.act, self.stride, self.padding = act, strides, kernel // 2
        if int8:
            register_conv_quant(self, cin, features, kernel)
            return
        self.Conv_0 = nn.Conv2d(cin, features, kernel, strides, kernel // 2, bias=False)
        # Flax momentum 0.9 on the running average is torch momentum 0.1.
        self.BatchNorm_0 = FlaxBatchNorm2d(features, eps=BN_EPS, momentum=0.1)

    def forward(self, x):
        if isinstance(x, QT):
            return conv_quant(self, x, self.stride, self.padding, self.act, act_kind="relu")
        x = self.BatchNorm_0(self.Conv_0(x))
        y = F.relu(x) if self.act else x
        record_absmax(self, "out_absmax", y)
        return y


def avg_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """Flax ``avg_pool((2, 2), strides=(2, 2), padding="SAME")``: an odd edge
    gets one zero row or column after it, and the zeros count in the mean."""
    h, w = x.shape[-2:]
    return F.avg_pool2d(F.pad(x, (0, w % 2, 0, h % 2)), 2, 2)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 (4× width), plus the shortcut; ``_ConvBN_3``
    projects the shortcut where the width or the stride changes: with
    ``vd``, after a 2×2 average pool where the stride does (the -vd
    shortcut); without, as a strided 1×1 conv."""

    def __init__(self, cin: int, features: int, strides: int = 1, int8: bool = False,
                 vd: bool = True):
        super().__init__()
        out_ch = features * 4
        self._ConvBN_0 = _ConvBN(cin, features, 1, 1, int8=int8)
        self._ConvBN_1 = _ConvBN(features, features, 3, strides, int8=int8)
        self._ConvBN_2 = _ConvBN(features, out_ch, 1, 1, act=False, int8=int8)
        self.project = cin != out_ch or strides != 1
        self.pool = vd and strides != 1
        if self.project:
            self._ConvBN_3 = _ConvBN(cin, out_ch, 1, 1 if self.pool else strides, act=False,
                                     int8=int8)
        if int8:
            register_quant(self, "s_add_0", torch.ones(()))

    def forward(self, x):
        y = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        residual = x
        quant = isinstance(x, QT)
        if self.project:
            if self.pool and quant:
                # Average pooling is linear: pool the codes in fp32 and round
                # back at the unchanged scale (the mean never exceeds the max).
                pooled = avg_pool_2x2_same(residual.q.float())
                residual = QT(torch.clamp(torch.round(pooled), -127, 127).to(torch.int8),
                              residual.s)
            elif self.pool:
                residual = avg_pool_2x2_same(residual)
            residual = self._ConvBN_3(residual)
        if quant:
            return requant_add(y, residual, self.s_add_0, relu=True)
        out = F.relu(y + residual)
        record_absmax(self, "add0_absmax", out)
        return out


class ResNet(nn.Module):
    """ResNet trunk. ``num_classes=None``: detection-backbone mode, the four
    stage maps (strides 4/8/16/32); else the logits ``(B, num_classes)`` of
    the mean-pooled last map through ``Dense_0``. ``vd``: the deep 3×3
    stem and the avg-pool shortcut; without it the single 7×7 stride-2
    stem (padding 3) and the strided 1×1 shortcut. The classifier is fp
    only (JAX never quantizes it) and is initialised as Flax initialises
    it, from ``generator`` (Flax's ``lecun_normal`` kernels, zero biases);
    the backbone's convs keep torch's init (RT-DETR sets its own)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 remat: bool = False, int8: bool = False, vd: bool = True,
                 num_classes: "int | None" = None,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        if int8 and num_classes is not None:
            raise ValueError("the int8 ResNet is the backbone only (num_classes=None)")
        self.remat = remat
        self.num_classes = num_classes
        if vd:   # deep stem: three 3×3 convs
            self._ConvBN_0 = _ConvBN(3, width // 2, 3, 2, int8=int8)
            self._ConvBN_1 = _ConvBN(width // 2, width // 2, 3, 1, int8=int8)
            self._ConvBN_2 = _ConvBN(width // 2, width, 3, 1, int8=int8)
            self._stem = ("_ConvBN_0", "_ConvBN_1", "_ConvBN_2")
        else:
            self._ConvBN_0 = _ConvBN(3, width, 7, 2, int8=int8)
            self._stem = ("_ConvBN_0",)
        self._stages = []
        ch, idx = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            names = []
            for j in range(n_blocks):
                strides = 2 if (j == 0 and i > 0) else 1
                name = f"BottleneckBlock_{idx}"
                self.add_module(name, BottleneckBlock(ch, width * 2**i, strides, int8=int8,
                                                      vd=vd))
                ch = width * 2**i * 4
                names.append(name)
                idx += 1
            self._stages.append(names)
        self.out_channels = [width * 2**i * 4 for i in range(len(stage_sizes))]
        if num_classes is not None:
            self.Dense_0 = nn.Linear(self.out_channels[-1], num_classes)
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, (nn.Conv2d, nn.Linear)):
                        lecun_normal_(mod.weight, generator)
                        if mod.bias is not None:
                            mod.bias.zero_()

    def forward(self, x):
        for name in self._stem:
            x = getattr(self, name)(x)
        if isinstance(x, QT):
            x = QT(max_pool_codes(x.q, 3, 2, 1), x.s)   # monotone: pool the codes
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        recompute = remat_active(self)
        for names in self._stages:
            for name in names:
                x = run_block(getattr(self, name), x, recompute)
            feats.append(x)
        if self.num_classes is None:
            return feats
        return self.Dense_0(x.mean((2, 3)))


def resnet50(num_classes: "int | None" = 1000, vd: bool = False, **kw) -> ResNet:
    """ResNet-50: the classifier by default; ``num_classes=None, vd=True``
    is RT-DETR's r50vd backbone."""
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, vd=vd, **kw)


def resnet18(num_classes: "int | None" = 1000, **kw) -> ResNet:
    """JAX's ``resnet18``: bottleneck blocks (2, 2, 2, 2), a cheaper stand-in
    of the basic-block original, vanilla unless ``vd=True``."""
    kw.setdefault("vd", False)
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, **kw)
