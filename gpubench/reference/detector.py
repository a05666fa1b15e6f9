"""Plain PyTorch reference of YOLO-s and MoE-YOLO-s (``arch="tpu"``).

A functional forward over a dict of float32 tensors named as the port's
``state_dict`` names them. It follows the architecture (Ultralytics
YOLOv8's C2f-style CSP stages, SPPF, PAN neck, decoupled DFL head; the
repository's space-to-depth stem and plain stages at /4 and /8; one
context-routed top-k expert FFN with a residual on each neck level) and
imports nothing of the port. Every product runs in float32 with TF32 off
(the caller sets the backend flags), or, for the control, on operands
rounded to a lower precision (:class:`Prec`).

``count_flops`` walks the same code on the ``meta`` device and counts the
model's products: each convolution's ``2·Cin·Cout·k²·Hout·Wout`` an image,
and each MoE level at the ``k`` experts a token that the model asks for.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
REG_MAX = 16
STRIDES = (8, 16, 32)
BASE_CHANNELS = (64, 128, 256, 512, 1024)
BASE_DEPTHS = (3, 6, 6, 3)
E4M3_MAX = 448.0


@dataclass
class Prec:
    """The precision the reference computes in. ``fp32`` is the
    reference itself. A lower one, for the control, rounds what a model in
    that precision would round: every product's operands and every stored
    activation (``bf16``: to bfloat16, the products computed in bfloat16;
    ``fp8``: to float8 e4m3 under a per-tensor scale, the products in
    float32)."""

    kind: str = "fp32"

    def _round(self, x):
        if self.kind == "bf16":
            return x.to(torch.bfloat16)
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()              # straight-through for backward

    def operands(self, *xs):
        if self.kind == "fp32":
            return xs
        return tuple(self._round(x) for x in xs)

    def act(self, x):
        """An activation as the model would store it, back in float32."""
        return x if self.kind == "fp32" else self._round(x).float()


@dataclass
class Counter:
    """Model FLOPs of one forward, by the walk."""

    flops: float = 0.0
    by_part: dict = field(default_factory=dict)

    def add(self, part: str, n: float) -> None:
        self.flops += n
        self.by_part[part] = self.by_part.get(part, 0.0) + n


def widths(cfg: dict) -> "list[int]":
    w, maxc = cfg["width_multiple"], cfg["max_channels"]
    return [max(8, int(round(min(c, maxc) * w / 8)) * 8) for c in BASE_CHANNELS]


def depths(cfg: dict) -> "list[int]":
    d = cfg["depth_multiple"]
    return [max(1, round(n * d)) for n in BASE_DEPTHS]


class Net:
    """One forward's context: weights, mode, precision, BatchNorm state."""

    def __init__(self, weights: dict, cfg: dict, *, train: bool = False,
                 prec: "Prec | None" = None, counter: "Counter | None" = None):
        self.w = weights
        self.cfg = cfg
        self.train = train
        self.prec = prec or Prec()
        self.counter = counter
        self.moe_aux = []
        self.expert_load = []
        self.batch_stats: dict = {}     # train mode: each BatchNorm's (mean, var)

    # -- blocks --------------------------------------------------------------
    def conv(self, name: str, x, stride: int = 1, act: bool = True):
        """``name.conv`` → BatchNorm ``name.bn`` → SiLU."""
        w = self.w[f"{name}.conv.weight"]
        k = w.shape[-1]
        if self.counter is not None:
            ho = (x.shape[2] + 2 * (k // 2) - k) // stride + 1
            wo = (x.shape[3] + 2 * (k // 2) - k) // stride + 1
            self.counter.add(name.split(".")[0], 2.0 * x.shape[0] * w.numel() * ho * wo)
        xo, wo_ = self.prec.operands(x, w)
        y = F.conv2d(xo, wo_, stride=stride, padding=k // 2).float()
        y = self.bn(name + ".bn", y)
        return self.prec.act(F.silu(y) if act else y)

    def bn(self, name: str, y):
        scale, bias = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.train:
            mean = y.mean((0, 2, 3))
            var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.batch_stats[name] = (mean.detach(), var.detach())
            mul = torch.rsqrt(var + BN_EPS) * scale
            return (y - mean[None, :, None, None]) * mul[None, :, None, None] \
                + bias[None, :, None, None]
        rm, rv = self.w[name + ".running_mean"], self.w[name + ".running_var"]
        inv = scale / torch.sqrt(rv + BN_EPS)
        return (y - rm[None, :, None, None]) * inv[None, :, None, None] + bias[None, :, None, None]

    def pred(self, name: str, x):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.counter is not None:
            self.counter.add("head", 2.0 * x.shape[0] * w.numel() * x.shape[2] * x.shape[3])
        xo, wo = self.prec.operands(x, w)
        return self.prec.act(F.conv2d(xo, wo).float() + b[None, :, None, None])

    def plain(self, name: str, x, blocks: int, shortcut: bool):
        for i in range(blocks):
            y = self.conv(f"{name}.ConvBNAct_{2 * i}", x)
            y = self.conv(f"{name}.ConvBNAct_{2 * i + 1}", y)
            x = self.prec.act(x + y) if shortcut and x.shape[1] == y.shape[1] else y
        return x

    def csp(self, name: str, x, blocks: int, shortcut: bool):
        y = self.conv(f"{name}.ConvBNAct_0", x, act=True)
        a, b = y.chunk(2, dim=1)
        outs = [a, b]
        for i in range(blocks):
            z = self.conv(f"{name}.Bottleneck_{i}.ConvBNAct_1",
                          self.conv(f"{name}.Bottleneck_{i}.ConvBNAct_0", b))
            b = self.prec.act(b + z) if shortcut else z
            outs.append(b)
        return self.conv(f"{name}.ConvBNAct_1", torch.cat(outs, 1))

    def sppf(self, name: str, x):
        x = self.conv(f"{name}.ConvBNAct_0", x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.conv(f"{name}.ConvBNAct_1", torch.cat(pools, 1))

    # -- trunk ---------------------------------------------------------------
    def backbone(self, x):
        d = depths(self.cfg)
        b, c, h, w = x.shape                                  # space-to-depth 4, (dy, dx, c)
        x = x.reshape(b, c, h // 4, 4, w // 4, 4).permute(0, 3, 5, 1, 2, 4)
        x = x.reshape(b, 16 * c, h // 4, w // 4)
        x = self.conv("backbone.SpaceToDepthStem_0.ConvBNAct_0", x)
        x = self.plain("backbone.PlainStage_0", x, d[0], True)
        x = self.conv("backbone.ConvBNAct_0", x, 2)
        p3 = self.plain("backbone.PlainStage_1", x, d[1], True)
        x = self.conv("backbone.ConvBNAct_1", p3, 2)
        p4 = self.csp("backbone.CSPStage_0", x, d[2], True)
        x = self.conv("backbone.ConvBNAct_2", p4, 2)
        x = self.csp("backbone.CSPStage_1", x, d[3], True)
        return p3, p4, self.sppf("backbone.SPPF_0", x)

    def neck(self, p3, p4, p5):
        n = depths(self.cfg)[3]
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        t4 = self.csp("neck.CSPStage_0", torch.cat([up(p5), p4], 1), n, False)
        n3 = self.plain("neck.PlainStage_0", torch.cat([up(t4), p3], 1), n, False)
        n4 = self.csp("neck.CSPStage_1", torch.cat([self.conv("neck.ConvBNAct_0", n3, 2), t4], 1),
                      n, False)
        n5 = self.csp("neck.CSPStage_2", torch.cat([self.conv("neck.ConvBNAct_1", n4, 2), p5], 1),
                      n, False)
        return [n3, n4, n5]

    # -- MoE level -----------------------------------------------------------
    def moe(self, level: int, fmap, context_ids):
        """Top-k routing of every location's token by ``token·W + bias[bin]``
        (softmax, the k largest probabilities, lower expert first among
        ties, gates renormalised), each token through its k experts'
        ``silu(x·W1 + b1)·W2 + b2``, the gated sum added to the token."""
        name = f"moe_level{level}"
        b, d, h, w = fmap.shape
        t = b * h * w
        e, k = self.cfg["num_experts"], self.cfg["top_k"]
        hid = self.w[f"{name}.experts_w1"].shape[-1]
        if self.counter is not None:
            self.counter.add("moe", t * k * 2.0 * (d * hid + hid * d) + 2.0 * t * d * e)
            return fmap
        tokens = fmap.permute(0, 2, 3, 1).reshape(t, d)
        ctx = context_ids.long().repeat_interleave(h * w)
        logits = tokens @ self.w[f"{name}.router.router_kernel"] \
            + self.w[f"{name}.router.context_bias"][ctx]
        probs = torch.softmax(logits, -1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
        top = torch.gather(probs, 1, order)
        gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)

        out = torch.zeros_like(tokens)
        w1, b1 = self.w[f"{name}.experts_w1"], self.w[f"{name}.experts_b1"]
        w2, b2 = self.w[f"{name}.experts_w2"], self.w[f"{name}.experts_b2"]
        for j in range(e):
            rows, slot = torch.nonzero(order == j, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = tokens[rows]
            xo, w1o = self.prec.operands(x, w1[j])
            mid = F.silu((xo @ w1o).float() + b1[j])
            mo, w2o = self.prec.operands(mid, w2[j])
            y = (mo @ w2o).float() + b2[j]
            out = out.index_add(0, rows, y * gates[rows, slot][:, None])

        counts = torch.bincount(order.reshape(-1), minlength=e).float()
        f = counts / (t * k) * e
        balance = (f * probs.mean(0)).sum() * e
        z = (torch.logsumexp(logits, -1) ** 2).mean()
        self.moe_aux.append(0.01 * balance + 1e-3 * z)
        self.expert_load.append(counts / t)
        return self.prec.act(tokens + out).reshape(b, h, w, d).permute(0, 3, 1, 2)

    # -- head ----------------------------------------------------------------
    def head(self, feats, img_h: int, img_w: int):
        box_maps, cls_maps = [], []
        for i, f in enumerate(feats):
            bx = self.conv(f"head.box{i}_conv2", self.conv(f"head.box{i}_conv1", f))
            box_maps.append(self.pred(f"head.box{i}_pred", bx))
            cx = self.conv(f"head.cls{i}_conv2", self.conv(f"head.cls{i}_conv1", f))
            cls_maps.append(self.pred(f"head.cls{i}_pred", cx))
        if self.counter is not None:
            return None
        flat = lambda m: m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, m.shape[1])  # noqa: E731
        box_logits = torch.cat([flat(m) for m in box_maps], 1)
        cls_logits = torch.cat([flat(m) for m in cls_maps], 1)
        points, strides = anchors(img_h, img_w, box_logits.device)
        prob = torch.softmax(box_logits.reshape(*box_logits.shape[:2], 4, REG_MAX), -1)
        ltrb = (prob * torch.arange(REG_MAX, device=prob.device, dtype=prob.dtype)).sum(-1)
        ltrb = ltrb * strides
        boxes = torch.cat([points - ltrb[..., :2], points + ltrb[..., 2:]], -1)
        return {"cls_logits": cls_logits, "box_logits": box_logits, "boxes": boxes,
                "anchor_points": points, "anchor_strides": strides}


def anchors(img_h: int, img_w: int, device):
    pts, strides = [], []
    for s in STRIDES:
        ys, xs = torch.meshgrid(torch.arange(img_h // s, device=device),
                                torch.arange(img_w // s, device=device), indexing="ij")
        p = torch.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2).float()
        pts.append(p)
        strides.append(torch.full((p.shape[0], 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def forward(weights: dict, cfg: dict, images_u8, context_ids=None, *, train: bool = False,
            prec: "Prec | None" = None, batch_stats: "dict | None" = None) -> dict:
    """uint8 NHWC images → the detector's outputs, as the port's model gives
    them for ``images / 255``."""
    return forward_float(weights, cfg, images_u8.float() / 255.0, context_ids, train=train,
                         prec=prec, batch_stats=batch_stats)


def forward_float(weights: dict, cfg: dict, x, context_ids=None, *, train: bool = False,
                  prec: "Prec | None" = None, batch_stats: "dict | None" = None) -> dict:
    """NHWC float images in [0, 1] → the outputs. A MoE configuration adds
    ``moe_aux_loss`` (the mean over levels) and ``expert_load``. In train
    mode ``batch_stats``, if given, receives each BatchNorm's batch mean and
    variance by name."""
    net = Net(weights, cfg, train=train, prec=prec)
    if batch_stats is not None:
        net.batch_stats = batch_stats
    img_h, img_w = x.shape[1:3]
    feats = net.neck(*net.backbone(x.permute(0, 3, 1, 2)))
    if cfg.get("num_experts"):
        if context_ids is None:
            context_ids = torch.full((x.shape[0],), cfg["num_context_bins"] - 1,
                                     device=x.device)
        feats = [net.moe(i, f, context_ids) for i, f in enumerate(feats)]
    out = net.head(feats, img_h, img_w)
    if cfg.get("num_experts"):
        out["moe_aux_loss"] = sum(net.moe_aux) / len(net.moe_aux)
        out["expert_load"] = torch.stack(net.expert_load)
    return out


def count_flops(cfg: dict, batch: int, img_h: int, img_w: int, weight_shapes: dict) -> Counter:
    """Model FLOPs of one forward over ``batch`` images, walked on the
    ``meta`` device from the weights' shapes."""
    counter = Counter()
    meta = {k: torch.empty(s, device="meta") for k, s in weight_shapes.items()}
    net = Net(meta, cfg, counter=counter)
    x = torch.empty((batch, 3, img_h, img_w), device="meta")
    feats = net.neck(*net.backbone(x))
    if cfg.get("num_experts"):
        feats = [net.moe(i, f, None) for i, f in enumerate(feats)]
    net.head(feats, img_h, img_w)
    return counter
