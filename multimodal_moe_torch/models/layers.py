"""Detector building blocks (PyTorch, NCHW inside), fp path.

Counterpart of ``multimodal_moe_tpu/models/layers.py``. Submodules carry the
names Flax gives them (``ConvBNAct_0``, ``Bottleneck_1``, ``conv``, ``bn``)
so that ``convert.flax_to_state_dict`` maps a Flax tree onto these modules
name for name and ``load_state_dict(strict=True)`` catches any miss.
Convs use explicit symmetric padding, BatchNorm eps 1e-3, SiLU.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


class AutoNamer:
    """Flax's compact auto-naming: ``ClassName_<i>`` with a per-class count."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def __call__(self, cls) -> str:
        base = cls.__name__
        i = self._counts.get(base, 0)
        self._counts[base] = i + 1
        return f"{base}_{i}"


def add_auto(parent: nn.Module, nm: AutoNamer, module: nn.Module) -> str:
    """Register ``module`` on ``parent`` under its Flax auto-name; return it."""
    name = nm(type(module))
    parent.add_module(name, module)
    return name


def autopad(k: int, d: int = 1) -> int:
    """'same' padding for odd kernel sizes with dilation."""
    k_eff = d * (k - 1) + 1
    return k_eff // 2


def lecun_normal_(w: torch.Tensor, generator: "torch.Generator | None" = None):
    """Flax's default conv and Dense kernel init: truncated normal (±2σ)
    with variance 1/fan_in, σ corrected for the truncation. ``w`` is a torch
    weight, output channels first: fan_in is everything else."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w


class ConvBNAct(nn.Module):
    """Conv → BatchNorm (running statistics in eval) → SiLU."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 strides: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        p = autopad(kernel_size)
        self.conv = nn.Conv2d(cin, features, kernel_size, strides, p,
                              groups=groups, bias=False)
        # Flax momentum 0.97 on the running average is torch momentum 0.03.
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS, momentum=0.03)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two 3×3 convs with optional residual."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBNAct_0 = ConvBNAct(cin, hidden, 3)
        self.ConvBNAct_1 = ConvBNAct(hidden, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        return x + y if self.add else y


class CSPStage(nn.Module):
    """Cross-stage-partial block (C2f-style): split → n bottlenecks with dense
    reuse of intermediates → fuse."""

    def __init__(self, cin: int, features: int, num_blocks: int = 1,
                 shortcut: bool = True):
        super().__init__()
        hidden = features // 2
        nm = AutoNamer()
        self._first = add_auto(self, nm, ConvBNAct(cin, 2 * hidden, 1))
        self._blocks = [
            add_auto(self, nm, Bottleneck(hidden, hidden, shortcut, expansion=1.0))
            for _ in range(num_blocks)
        ]
        self._last = add_auto(
            self, nm, ConvBNAct((2 + num_blocks) * hidden, features, 1)
        )

    def forward(self, x):
        a, b = getattr(self, self._first)(x).chunk(2, dim=1)
        outs = [a, b]
        for name in self._blocks:
            b = getattr(self, name)(b)
            outs.append(b)
        return getattr(self, self._last)(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5×5 max-pools (stride 1,
    -inf padding), concatenated."""

    def __init__(self, cin: int, features: int, pool_size: int = 5):
        super().__init__()
        hidden = features // 2
        self.pool_size = pool_size
        self.ConvBNAct_0 = ConvBNAct(cin, hidden, 1)
        self.ConvBNAct_1 = ConvBNAct(4 * hidden, features, 1)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        p = self.pool_size
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], p, stride=1, padding=p // 2))
        return self.ConvBNAct_1(torch.cat(pools, dim=1))


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B,C,H,W) → (B,r²·C,H/r,W/r) with channel order (dy, dx, c), the
    order of the JAX function on NHWC. ``F.pixel_unshuffle`` orders the
    channels (c, dy, dx) instead, which would scramble the stem's weights."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)            # (b, c, ho, dy, wo, dx)
    x = x.permute(0, 3, 5, 1, 2, 4)                      # (b, dy, dx, c, ho, wo)
    return x.reshape(b, r * r * c, h // r, w // r)


class SpaceToDepthStem(nn.Module):
    """Space-to-depth(r) then one 3×3 conv."""

    def __init__(self, cin: int, features: int, ratio: int = 4):
        super().__init__()
        self.ratio = ratio
        self.ConvBNAct_0 = ConvBNAct(cin * ratio * ratio, features, 3)

    def forward(self, x):
        return self.ConvBNAct_0(space_to_depth(x, self.ratio))


class PlainStage(nn.Module):
    """n × (two full-width 3×3 convs + residual); the residual is skipped
    where the widths differ (the first conv may reduce channels)."""

    def __init__(self, cin: int, features: int, num_blocks: int = 1,
                 shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.features = features
        for i in range(num_blocks):
            self.add_module(f"ConvBNAct_{2 * i}",
                            ConvBNAct(cin if i == 0 else features, features, 3))
            self.add_module(f"ConvBNAct_{2 * i + 1}", ConvBNAct(features, features, 3))
        self.num_blocks = num_blocks

    def forward(self, x):
        for i in range(self.num_blocks):
            y = getattr(self, f"ConvBNAct_{2 * i}")(x)
            y = getattr(self, f"ConvBNAct_{2 * i + 1}")(y)
            x = x + y if self.shortcut and x.shape[1] == self.features else y
        return x


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class MLP(nn.Module):
    """``Dense_0 … Dense_{n-1}`` with ReLU between them."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 2):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x
