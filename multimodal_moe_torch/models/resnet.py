"""ResNet-vd (PyTorch, NCHW), fp path, as RT-DETR's detection backbone:
deep 3-conv stem and bottleneck stages with the avg-pool shortcut.

Counterpart of ``multimodal_moe_tpu/models/resnet.py``. Submodules carry the
Flax names (``_ConvBN_0``, ``Conv_0``, ``BatchNorm_0``,
``BottleneckBlock_{i}``). This family's BatchNorm is eps 1e-5 with ReLU, not
the eps 1e-3 / SiLU of ``layers.ConvBNAct``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class _ConvBN(nn.Module):
    """Conv (symmetric padding k//2, no bias) → BatchNorm → ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, strides: int = 1,
                 act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, kernel, strides, kernel // 2, bias=False)
        # Flax momentum 0.9 on the running average is torch momentum 0.1.
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS, momentum=0.1)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


def avg_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """Flax ``avg_pool((2, 2), strides=(2, 2), padding="SAME")``: an odd edge
    gets one zero row or column after it, and the zeros count in the mean."""
    h, w = x.shape[-2:]
    return F.avg_pool2d(F.pad(x, (0, w % 2, 0, h % 2)), 2, 2)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 (4× width), plus the shortcut; ``_ConvBN_3``
    projects the shortcut where the width or the stride changes, after a
    2×2 average pool where the stride does (the -vd shortcut)."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        out_ch = features * 4
        self._ConvBN_0 = _ConvBN(cin, features, 1, 1)
        self._ConvBN_1 = _ConvBN(features, features, 3, strides)
        self._ConvBN_2 = _ConvBN(features, out_ch, 1, 1, act=False)
        self.project = cin != out_ch or strides != 1
        self.pool = strides != 1
        if self.project:
            self._ConvBN_3 = _ConvBN(cin, out_ch, 1, 1 if self.pool else strides, act=False)

    def forward(self, x):
        y = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        residual = x
        if self.project:
            if self.pool:
                residual = avg_pool_2x2_same(residual)
            residual = self._ConvBN_3(residual)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-vd trunk in detection-backbone mode (the JAX model's
    ``vd=True, num_classes=None``): returns the four stage maps, strides
    4/8/16/32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        # Deep stem: three 3×3 convs.
        self._ConvBN_0 = _ConvBN(3, width // 2, 3, 2)
        self._ConvBN_1 = _ConvBN(width // 2, width // 2, 3, 1)
        self._ConvBN_2 = _ConvBN(width // 2, width, 3, 1)
        self._stages = []
        ch, idx = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            names = []
            for j in range(n_blocks):
                strides = 2 if (j == 0 and i > 0) else 1
                name = f"BottleneckBlock_{idx}"
                self.add_module(name, BottleneckBlock(ch, width * 2**i, strides))
                ch = width * 2**i * 4
                names.append(name)
                idx += 1
            self._stages.append(names)
        self.out_channels = [width * 2**i * 4 for i in range(len(stage_sizes))]

    def forward(self, x):
        x = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for names in self._stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


def resnet50(**kw) -> ResNet:
    """ResNet-50-vd, RT-DETR's backbone."""
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)
