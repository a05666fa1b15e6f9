"""Detector building blocks (PyTorch, NCHW inside): the fp path and the
int8 serving path.

Counterpart of ``multimodal_moe_tpu/models/layers.py``. Submodules carry the
names Flax gives them (``ConvBNAct_0``, ``Bottleneck_1``, ``conv``, ``bn``)
so that ``convert.flax_to_state_dict`` maps a Flax tree onto these modules
name for name and ``load_state_dict(strict=True)`` catches any miss.
Convs use explicit symmetric padding, BatchNorm eps 1e-3, SiLU. In train
mode every BatchNorm of the port is :class:`FlaxBatchNorm2d`: Flax's batch
statistics and running-average rule.

Built with ``int8=True``, a block holds the quant tensors of the JAX
module's ``quant`` collection instead of its conv and BatchNorm
(``quant.register_quant``) and takes a :class:`..quant.QT` of int8 codes:
an exact int32 conv (``ops/int8_conv.py``), then :func:`apply_i8_epilogue`.
The fp blocks record the calibration statistics JAX sows
(``quant.record_absmax``: ``out_absmax``, ``add{i}_absmax``).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.int8_conv import int8_conv2d
from ..parallel.mesh import active_mesh
from ..quant import (
    QT,
    max_pool_codes,
    q_split2,
    qcat,
    quantize_to,
    record_absmax,
    register_quant,
)

BN_EPS = 1e-3
I8_EPILOGUES = ("bf16", "silu", "hswish", "linear")


def apply_i8_epilogue(y32, scale, bias, act: bool, s_out, act_kind: str = "silu") -> torch.Tensor:
    """The int8 conv epilogue: dequantize the int32 accumulator with
    ``scale``, add ``bias``, activate, requantize to ``s_out``. ``scale`` and
    ``bias`` broadcast against ``y32``.

    ``MMOE_I8_EPILOGUE`` (read at each call, as JAX reads it at trace time)
    selects the arithmetic, as in the JAX package:
      bf16   — dequant, bias and SiLU in bf16, requant from fp32 (default)
      silu   — fp32 throughout
      hswish — x·relu6(x + 3)/6 in fp32
      linear — no activation (a bound only, not a serving mode)
    ``act_kind="relu"`` (ResNet) takes ReLU in every mode.

    The bf16 mode rounds where XLA's CPU lowering of the JAX expression
    rounds: int32 → bf16 through float32 (two roundings above 2²⁴), the
    product to bf16, the bias add to bf16 unless it is the last step, the
    sigmoid as 1/(1 + exp(−y)) with every step rounded to bf16, and the last
    result (``y·σ(y)``, or the bias add) kept in float32 for the requant: XLA
    drops a bf16 rounding that a float32 convert follows."""
    mode = os.environ.get("MMOE_I8_EPILOGUE", "bf16")
    if mode not in I8_EPILOGUES:
        raise ValueError(f"MMOE_I8_EPILOGUE must be one of {I8_EPILOGUES}, got {mode!r}")
    if mode == "bf16":
        bf16 = torch.bfloat16
        y = y32.to(bf16) * scale.to(bf16)
        if not act:
            return quantize_to(y.float() + bias.to(bf16).float(), s_out)
        y = y + bias.to(bf16)
        if act_kind == "relu":
            return quantize_to(torch.relu(y).float(), s_out)
        return quantize_to(y.float() * (1 / (1 + torch.exp(-y))).float(), s_out)
    y = y32.float() * scale + bias
    if act:
        if act_kind == "relu":
            y = torch.relu(y)
        elif mode == "hswish":
            y = y * torch.clamp(y + 3.0, 0.0, 6.0) * (1.0 / 6.0)
        elif mode == "silu":
            y = y * torch.sigmoid(y)
    return quantize_to(y, s_out)


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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's train-mode rule; eval mode is torch's.

    Train mode normalises with the float32 batch statistics of Flax's
    ``use_fast_variance``: ``var = max(0, E[x²] − E[x]²)``, then
    ``(x − mean)·(rsqrt(var + eps)·scale) + bias``, and moves the running
    averages by ``m·ra + (1 − m)·stat`` with Flax's momentum ``m = 1 −
    self.momentum`` and the *biased* batch variance (torch's own train mode
    puts the unbiased one there). ``update_stats = False`` normalises the same
    way and leaves the running averages alone: a block that ``remat``
    recomputes during backward commits them once, as ``nn.remat`` does.

    Under an active mesh (``parallel.mesh.use_mesh``) the statistics are
    those of the global batch: ``[Σx, Σx², count]`` of the rank's slice are
    summed over every rank before ``mean`` and ``E[x²]`` are formed, and the
    gradient flows back through that sum (as in SyncBatchNorm); the running
    averages then move identically on every rank.
    """

    update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mesh = active_mesh()
        if mesh is None:
            mean = xf.mean((0, 2, 3))
            ex2 = (xf * xf).mean((0, 2, 3))
        else:
            c = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // c)
            sums = mesh.all_reduce(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                              count]))
            mean, ex2 = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
        var = (ex2 - mean * mean).clamp_min(0.0)
        if self.update_stats:
            m = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


@contextlib.contextmanager
def stats_frozen(module: nn.Module):
    """Normalise as in train mode but leave the running statistics alone."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            del m.update_stats


def remat_active(module: nn.Module) -> bool:
    """Whether ``module`` (with a ``remat`` flag) recomputes its blocks now:
    only in a train-mode forward that builds a graph."""
    return module.remat and module.training and torch.is_grad_enabled()


def run_block(module: nn.Module, x, recompute: bool):
    """``module(x)``; with ``recompute``, its activations are not kept but
    computed again during backward (``torch.utils.checkpoint``, the JAX
    models' ``nn.remat``), the running statistics frozen on the recompute so
    that they move once."""
    if not recompute:
        return module(x)
    return checkpoint(module, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), stats_frozen(module)))


def register_conv_quant(module: nn.Module, cin: int, features: int, k: int,
                        requant: bool = True) -> None:
    """The quant leaves of an int8 conv: ``w_q`` (OIHW int8), ``s_w``, ``b``
    and, where the output is requantized, ``s_out``."""
    register_quant(module, "w_q", torch.zeros((features, cin, k, k), dtype=torch.int8))
    register_quant(module, "s_w", torch.ones(features))
    register_quant(module, "b", torch.zeros(features))
    if requant:
        register_quant(module, "s_out", torch.ones(()))


def conv_quant(module: nn.Module, x: QT, stride: int, padding: int, act: bool,
               act_kind: str = "silu") -> QT:
    """An int8 conv block's forward: exact int32 conv, then the epilogue."""
    y32 = int8_conv2d(x.q, module.w_q, stride, padding)
    c = module.s_w.shape[0]
    q = apply_i8_epilogue(y32, (x.s * module.s_w).view(1, c, 1, 1), module.b.view(1, c, 1, 1),
                          act, module.s_out, act_kind)
    return QT(q, module.s_out)


class ConvBNAct(nn.Module):
    """Conv → BatchNorm (running statistics in eval) → SiLU; with ``int8``
    the folded int8 conv and its epilogue on a ``QT``."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 strides: int = 1, groups: int = 1, act: bool = True, int8: bool = False):
        super().__init__()
        p = autopad(kernel_size)
        self.act, self.stride, self.padding = act, strides, p
        if int8:
            if groups != 1:
                raise ValueError("the int8 conv takes groups=1 only")
            register_conv_quant(self, cin, features, kernel_size)
            return
        self.conv = nn.Conv2d(cin, features, kernel_size, strides, p,
                              groups=groups, bias=False)
        # Flax momentum 0.97 on the running average is torch momentum 0.03.
        self.bn = FlaxBatchNorm2d(features, eps=BN_EPS, momentum=0.03)

    def forward(self, x):
        if isinstance(x, QT):
            return conv_quant(self, x, self.stride, self.padding, self.act)
        x = self.bn(self.conv(x))
        y = F.silu(x) if self.act else x
        record_absmax(self, "out_absmax", y)
        return y


class Bottleneck(nn.Module):
    """Two 3×3 convs with optional residual."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, int8: bool = False):
        super().__init__()
        hidden = int(features * expansion)
        self.ConvBNAct_0 = ConvBNAct(cin, hidden, 3, int8=int8)
        self.ConvBNAct_1 = ConvBNAct(hidden, features, 3, int8=int8)
        self.add = shortcut and cin == features
        if int8 and self.add:
            register_quant(self, "s_add_0", torch.ones(()))

    def forward(self, x):
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        if not self.add:
            return y
        if isinstance(x, QT):
            return requant_add(x, y, self.s_add_0)
        y = x + y
        record_absmax(self, "add0_absmax", y)
        return y


def requant_add(x: QT, y: QT, s_add: torch.Tensor, relu: bool = False) -> QT:
    """Residual add of two QTs in fp32, requantized to ``s_add``."""
    z = x.q.float() * x.s + y.q.float() * y.s
    return QT(quantize_to(torch.relu(z) if relu else z, s_add), s_add)


class CSPStage(nn.Module):
    """Cross-stage-partial block (C2f-style): split → n bottlenecks with dense
    reuse of intermediates → fuse."""

    def __init__(self, cin: int, features: int, num_blocks: int = 1,
                 shortcut: bool = True, int8: bool = False):
        super().__init__()
        hidden = features // 2
        nm = AutoNamer()
        self._first = add_auto(self, nm, ConvBNAct(cin, 2 * hidden, 1, int8=int8))
        self._blocks = [
            add_auto(self, nm, Bottleneck(hidden, hidden, shortcut, expansion=1.0, int8=int8))
            for _ in range(num_blocks)
        ]
        self._last = add_auto(
            self, nm, ConvBNAct((2 + num_blocks) * hidden, features, 1, int8=int8)
        )

    def forward(self, x):
        y = getattr(self, self._first)(x)
        quant = isinstance(y, QT)
        a, b = q_split2(y) if quant else y.chunk(2, dim=1)
        outs = [a, b]
        for name in self._blocks:
            b = getattr(self, name)(b)
            outs.append(b)
        return getattr(self, self._last)(concat(outs))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5×5 max-pools (stride 1,
    -inf padding), concatenated."""

    def __init__(self, cin: int, features: int, pool_size: int = 5, int8: bool = False):
        super().__init__()
        hidden = features // 2
        self.pool_size = pool_size
        self.ConvBNAct_0 = ConvBNAct(cin, hidden, 1, int8=int8)
        self.ConvBNAct_1 = ConvBNAct(4 * hidden, features, 1, int8=int8)

    def forward(self, x):
        x = self.ConvBNAct_0(x)
        p = self.pool_size
        quant = isinstance(x, QT)
        # Max-pooling is monotone: the int8 codes pool directly and keep the
        # scale, so the four parts share it and qcat only concatenates.
        pool = max_pool_codes if quant else F.max_pool2d
        pools = [x.q if quant else x]
        for _ in range(3):
            pools.append(pool(pools[-1], p, 1, p // 2))
        if quant:
            return self.ConvBNAct_1(qcat([QT(q, x.s) for q in pools]))
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

    def __init__(self, cin: int, features: int, ratio: int = 4, int8: bool = False):
        super().__init__()
        self.ratio = ratio
        self.ConvBNAct_0 = ConvBNAct(cin * ratio * ratio, features, 3, int8=int8)

    def forward(self, x):
        if isinstance(x, QT):
            return self.ConvBNAct_0(QT(space_to_depth(x.q, self.ratio), x.s))
        return self.ConvBNAct_0(space_to_depth(x, self.ratio))


class PlainStage(nn.Module):
    """n × (two full-width 3×3 convs + residual); the residual is skipped
    where the widths differ (the first conv may reduce channels)."""

    def __init__(self, cin: int, features: int, num_blocks: int = 1,
                 shortcut: bool = True, int8: bool = False):
        super().__init__()
        self.shortcut = shortcut
        self.features = features
        for i in range(num_blocks):
            c = cin if i == 0 else features
            self.add_module(f"ConvBNAct_{2 * i}", ConvBNAct(c, features, 3, int8=int8))
            self.add_module(f"ConvBNAct_{2 * i + 1}", ConvBNAct(features, features, 3, int8=int8))
            if int8 and shortcut and c == features:
                register_quant(self, f"s_add_{i}", torch.ones(()))
        self.num_blocks = num_blocks

    def forward(self, x):
        for i in range(self.num_blocks):
            y = getattr(self, f"ConvBNAct_{2 * i}")(x)
            y = getattr(self, f"ConvBNAct_{2 * i + 1}")(y)
            quant = isinstance(x, QT)
            if not (self.shortcut and (x.q if quant else x).shape[1] == self.features):
                x = y
            elif quant:
                x = requant_add(x, y, getattr(self, f"s_add_{i}"))
            else:
                x = x + y
                record_absmax(self, f"add{i}_absmax", x)
        return x


def upsample2x(x):
    """Nearest-neighbour 2× upsample (NCHW); a ``QT`` upsamples its codes
    (written channels-last, the layout the next int8 conv reads) and keeps
    its scale."""
    if not isinstance(x, QT):
        return F.interpolate(x, scale_factor=2, mode="nearest")
    q = x.q.permute(0, 2, 3, 1)
    b, h, w, c = q.shape
    q = q[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    return QT(q.permute(0, 3, 1, 2), x.s)


def concat(xs):
    """Channel concat of NCHW maps, or of QTs by ``quant.qcat``."""
    return qcat(xs) if isinstance(xs[0], QT) else torch.cat(xs, dim=1)


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
