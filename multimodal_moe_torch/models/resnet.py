"""ResNet-vd (PyTorch, NCHW), fp and int8, as RT-DETR's detection backbone:
deep 3-conv stem and bottleneck stages with the avg-pool shortcut.

Counterpart of ``multimodal_moe_tpu/models/resnet.py``. Submodules carry the
Flax names (``_ConvBN_0``, ``Conv_0``, ``BatchNorm_0``,
``BottleneckBlock_{i}``). This family's BatchNorm is eps 1e-5 with ReLU, not
the eps 1e-3 / SiLU of ``layers.ConvBNAct``. ``remat=True`` recomputes each
bottleneck block during backward (``torch.utils.checkpoint``, the JAX
model's ``nn.remat``); the recompute leaves the running statistics alone.
With ``int8=True`` the blocks run on ``quant.QT`` codes: the folded convs with
a ReLU epilogue, the residual add requantized to ``s_add_0``, the shortcut's
average pool on the codes in fp32 (rounded back half to even at the
unchanged scale) and the stem's max-pool on the codes.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..quant import QT, max_pool_codes, record_absmax, register_quant
from .layers import FlaxBatchNorm2d, conv_quant, register_conv_quant, requant_add

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
    projects the shortcut where the width or the stride changes, after a
    2×2 average pool where the stride does (the -vd shortcut)."""

    def __init__(self, cin: int, features: int, strides: int = 1, int8: bool = False):
        super().__init__()
        out_ch = features * 4
        self._ConvBN_0 = _ConvBN(cin, features, 1, 1, int8=int8)
        self._ConvBN_1 = _ConvBN(features, features, 3, strides, int8=int8)
        self._ConvBN_2 = _ConvBN(features, out_ch, 1, 1, act=False, int8=int8)
        self.project = cin != out_ch or strides != 1
        self.pool = strides != 1
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
    """ResNet-vd trunk in detection-backbone mode (the JAX model's
    ``vd=True, num_classes=None``): returns the four stage maps, strides
    4/8/16/32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 remat: bool = False, int8: bool = False):
        super().__init__()
        self.remat = remat
        # Deep stem: three 3×3 convs.
        self._ConvBN_0 = _ConvBN(3, width // 2, 3, 2, int8=int8)
        self._ConvBN_1 = _ConvBN(width // 2, width // 2, 3, 1, int8=int8)
        self._ConvBN_2 = _ConvBN(width // 2, width, 3, 1, int8=int8)
        self._stages = []
        ch, idx = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            names = []
            for j in range(n_blocks):
                strides = 2 if (j == 0 and i > 0) else 1
                name = f"BottleneckBlock_{idx}"
                self.add_module(name, BottleneckBlock(ch, width * 2**i, strides, int8=int8))
                ch = width * 2**i * 4
                names.append(name)
                idx += 1
            self._stages.append(names)
        self.out_channels = [width * 2**i * 4 for i in range(len(stage_sizes))]

    def forward(self, x):
        x = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        if isinstance(x, QT):
            x = QT(max_pool_codes(x.q, 3, 2, 1), x.s)   # monotone: pool the codes
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for names in self._stages:
            for name in names:
                block = getattr(self, name)
                if recompute:
                    x = checkpoint(block, x, use_reentrant=False,
                                   context_fn=lambda b=block: (contextlib.nullcontext(),
                                                               _stats_frozen(b)))
                else:
                    x = block(x)
            feats.append(x)
        return feats


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    """Normalise as in train mode but leave the running statistics alone."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            del m.update_stats


def resnet50(**kw) -> ResNet:
    """ResNet-50-vd, RT-DETR's backbone."""
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)
