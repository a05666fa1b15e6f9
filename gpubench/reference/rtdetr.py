"""Plain PyTorch reference of RT-DETR r50vd as the repository builds it.

A functional forward over a dict of float32 tensors named as the port's
``state_dict`` names them, written from RT-DETRv2's description
(``lyuwenyu/RT-DETR``, ``rtdetrv2_pytorch``): a ResNet-50-vd trunk (deep
3×3 stem, bottlenecks with the stride on the 3×3 conv and the average-pool
shortcut), the hybrid encoder (1×1 input projections, one AIFI transformer
layer on the stride-32 map, CCFF top-down then bottom-up fusion), IoU-aware
query selection of the top ``num_queries`` anchors, a decoder of
self-attention, multi-scale deformable cross-attention and an FFN with
iterative box refinement, and in training the contrastive denoising
queries and the DETR set loss with its Hungarian matcher. It imports
nothing of the port.

Where the repository departs from the published model (the same list as
``gpubench/configs/rtdetr_r50vd.json``'s ``assumed``), it is noted where it
is made: CCFF fuses with two-block plain stages (``arch="tpu"``) of 3×3
ConvBN-SiLU, not CSPRepLayer; LayerNorm eps 1e-6 and tanh GELU (Flax's);
2 static denoising groups over every ground-truth slot; trained BatchNorm;
one AdamW learning rate with clip 10.

Every product runs in float32 with TF32 off (the caller sets the backend
flags), or, for the control, on operands rounded to a lower precision
(:class:`.detector.Prec`). The deformable sampling is ``F.grid_sample``
per level (``align_corners=False``, zero padding) and the attention-
weighted sum, the upstream formulation. The selection of the top anchors
and the assignment of the matcher can be given (``topk``, ``assigned``):
the check hands the program's own to the reference, so that logits and
losses are compared on the same picks, and compares the picks separately.

``count_flops`` walks the same code on the ``meta`` device: every
convolution's and Linear's multiply-adds, the attention products, and the
deformable sampling as its multiply-adds (4 corners × D a sampled point).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch.utils.checkpoint import checkpoint

from . import train as ref_train
from .detector import Counter, Prec

RESNET_BN_EPS = 1e-5     # the -vd trunk's BatchNorm
CONV_BN_EPS = 1e-3       # the encoder's ConvBN-SiLU (the repository's layers)
LN_EPS = 1e-6            # departure: Flax's LayerNorm eps (the published model: 1e-5)
NUM_LEVELS = 3
BIG_COST = 1e6
GRAD_CLIP = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def sincos_2d(h: int, w: int, dim: int, device) -> torch.Tensor:
    """(1, H·W, dim) fixed 2-D sine-cosine embedding: x then y, each
    sin then cos, temperature 10000, made in float64."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter) / quarter))
    parts = []
    for grid in (xs, ys):
        ang = grid.reshape(-1)[:, None] * omega[None]
        parts += [np.sin(ang), np.cos(ang)]
    return torch.as_tensor(np.concatenate(parts, 1).astype(np.float32), device=device)[None]


def anchors(level_shapes, device, grid_size: float = 0.05):
    """Anchor priors (ΣHW, 4) in inverse-sigmoid space, cxcywh with a side of
    0.05·2^level, and the mask (ΣHW,) of those whose four numbers all lie
    in (0.01, 0.99)."""
    out, valid = [], []
    for lvl, (h, w) in enumerate(level_shapes):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cx, cy = (xs + 0.5) / w, (ys + 0.5) / h
        side = np.full_like(cx, grid_size * 2.0 ** lvl)
        a = np.stack([cx, cy, side, side], -1).reshape(-1, 4)
        valid.append(((a > 0.01) & (a < 0.99)).all(-1))
        a = np.clip(a, 0.01, 0.99)
        out.append(np.log(a / (1 - a)))
    return (torch.as_tensor(np.concatenate(out).astype(np.float32), device=device),
            torch.as_tensor(np.concatenate(valid), device=device))


def grid_init(num_heads: int, num_levels: int, num_points: int) -> torch.Tensor:
    """The published init of ``sampling_offsets``' bias: head h points
    along the angle 2πh/NH (scaled so the larger coordinate is 1), point p
    at p + 1 times that, at every level."""
    th = np.arange(num_heads) * (2.0 * math.pi / num_heads)
    g = np.stack([np.cos(th), np.sin(th)], -1)
    g = g / np.abs(g).max(-1, keepdims=True)
    g = np.tile(g[:, None, None, :], (1, num_levels, num_points, 1))
    g = g * np.arange(1, num_points + 1).reshape(1, 1, num_points, 1)
    return torch.as_tensor(g.reshape(-1).astype(np.float32))


def cxcywh_to_xyxy(b):
    half = b[..., 2:4] * 0.5
    return torch.cat([b[..., 0:2] - half, b[..., 0:2] + half], -1)


def giou(a, b):
    """Generalised IoU of aligned xyxy boxes (broadcasting)."""
    def area(x):
        s = (x[..., 2:4] - x[..., 0:2]).clamp_min(0.0)
        return s[..., 0] * s[..., 1]

    wh = (torch.minimum(a[..., 2:4], b[..., 2:4]) - torch.maximum(a[..., 0:2], b[..., 0:2]))
    wh = wh.clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a) + area(b) - inter
    iou = inter / (union + 1e-7)
    ewh = (torch.maximum(a[..., 2:4], b[..., 2:4]) - torch.minimum(a[..., 0:2], b[..., 0:2]))
    ewh = ewh.clamp_min(0.0)
    enclose = ewh[..., 0] * ewh[..., 1]
    return iou - (enclose - union) / (enclose + 1e-7)


class Net:
    """One forward's context: weights, mode, precision, BatchNorm state,
    the FLOP counter of :func:`count_flops`."""

    def __init__(self, weights: dict, cfg: dict, *, train: bool = False,
                 prec: "Prec | None" = None, counter: "Counter | None" = None,
                 remat: bool = False):
        self.w = weights
        self.cfg = cfg
        self.train = train
        self.prec = prec or Prec()
        self.counter = counter
        self.remat = remat
        self.batch_stats: dict = {}
        self.part = "backbone"

    def count(self, n: float) -> None:
        if self.counter is not None:
            self.counter.add(self.part, float(n))

    # -- products ------------------------------------------------------------
    def conv(self, name: str, x, stride: int = 1):
        w = self.w[name]
        k = w.shape[-1]
        ho = (x.shape[2] + 2 * (k // 2) - k) // stride + 1
        wo = (x.shape[3] + 2 * (k // 2) - k) // stride + 1
        self.count(2.0 * x.shape[0] * w.numel() * ho * wo)
        xo, wo_ = self.prec.operands(x, w)
        return F.conv2d(xo, wo_, stride=stride, padding=k // 2).float()

    def linear(self, name: str, x, act: bool = True):
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        self.count(2.0 * x[..., 0].numel() * w.numel())
        xo, wo = self.prec.operands(x, w)
        y = F.linear(xo, wo).float() + b
        return self.prec.act(y) if act else y

    def mlp(self, name: str, x, layers: int):
        for i in range(layers):
            x = self.linear(f"{name}.Dense_{i}", x)
            if i < layers - 1:
                x = F.relu(x)
        return x

    def bn(self, name: str, y, eps: float):
        scale, bias = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        if self.train:                      # Flax's fast variance, as the repository trains
            mean = y.mean((0, 2, 3))
            var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.batch_stats[name] = (mean.detach(), var.detach())
            mul = torch.rsqrt(var + eps) * scale
            return (y - mean[None, :, None, None]) * mul[None, :, None, None] \
                + bias[None, :, None, None]
        rm, rv = self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        inv = scale / torch.sqrt(rv + eps)
        return (y - rm[None, :, None, None]) * inv[None, :, None, None] + bias[None, :, None, None]

    def layer_norm(self, name: str, x):
        return self.prec.act(F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                                          self.w[f"{name}.bias"], LN_EPS))

    # -- ResNet-50-vd ----------------------------------------------------------
    def conv_bn_relu(self, name: str, x, stride: int = 1, act: bool = True):
        y = self.bn(f"{name}.BatchNorm_0", self.conv(f"{name}.Conv_0.weight", x, stride),
                    RESNET_BN_EPS)
        return self.prec.act(F.relu(y) if act else y)

    def bottleneck(self, name: str, x, stride: int):
        y = self.conv_bn_relu(f"{name}._ConvBN_0", x)
        y = self.conv_bn_relu(f"{name}._ConvBN_1", y, stride)     # the stride on the 3×3
        y = self.conv_bn_relu(f"{name}._ConvBN_2", y, act=False)
        short = x
        if f"{name}._ConvBN_3.Conv_0.weight" in self.w:
            if stride != 1:                 # -vd: 2×2 average pool (odd edges padded), 1×1
                short = F.avg_pool2d(F.pad(short, (0, short.shape[3] % 2, 0,
                                                   short.shape[2] % 2)), 2, 2)
            short = self.conv_bn_relu(f"{name}._ConvBN_3", short, act=False)
        return self.prec.act(F.relu(y + short))

    def backbone(self, x):
        for i in range(3):                  # deep stem: three 3×3 convs, the first strided
            x = self.conv_bn_relu(f"backbone._ConvBN_{i}", x, 2 if i == 0 else 1)
        x = F.max_pool2d(x, 3, 2, 1)
        feats, idx = [], 0
        for stage, blocks in enumerate(self.cfg["backbone_depths"]):
            for j in range(blocks):
                stride = 2 if (j == 0 and stage > 0) else 1
                name = f"backbone.BottleneckBlock_{idx}"
                if self.remat and self.train and torch.is_grad_enabled():
                    x = checkpoint(self.bottleneck, name, x, stride, use_reentrant=False)
                else:
                    x = self.bottleneck(name, x, stride)
                idx += 1
            feats.append(x)
        return feats[1:]

    # -- hybrid encoder --------------------------------------------------------
    def conv_bn_silu(self, name: str, x, stride: int = 1, act: bool = True):
        y = self.bn(f"{name}.bn", self.conv(f"{name}.conv.weight", x, stride), CONV_BN_EPS)
        return self.prec.act(F.silu(y) if act else y)

    def plain_stage(self, name: str, x):
        """Departure: CCFF's fusion block is two ConvBN-SiLU pairs without a
        residual (``arch="tpu"``), where RT-DETRv2 has a CSPRepLayer."""
        i = 0
        while f"{name}.ConvBNAct_{2 * i}.conv.weight" in self.w:
            x = self.conv_bn_silu(f"{name}.ConvBNAct_{2 * i + 1}",
                                  self.conv_bn_silu(f"{name}.ConvBNAct_{2 * i}", x))
            i += 1
        return x

    def attention(self, name: str, q_in, k_in, v_in, mask=None):
        """Multi-head attention: q, k, v projections, q/√hd, softmax over
        the keys (``mask`` True where a query may attend), out projection."""
        b, tq, dim = q_in.shape
        tk = k_in.shape[1]
        nh = self.cfg["num_heads"]
        hd = dim // nh
        q = self.linear(f"{name}.query", q_in).view(b, tq, nh, hd).transpose(1, 2)
        k = self.linear(f"{name}.key", k_in).view(b, tk, nh, hd).transpose(1, 2)
        v = self.linear(f"{name}.value", v_in).view(b, tk, nh, hd).transpose(1, 2)
        self.count(2.0 * 2.0 * b * nh * tq * tk * hd)
        qo, ko = self.prec.operands(q / math.sqrt(hd), k)
        logits = torch.matmul(qo, ko.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask[None, None], torch.finfo(torch.float32).min)
        probs, vo = self.prec.operands(torch.softmax(logits, -1), v)
        y = self.prec.act(torch.matmul(probs, vo).float())
        return self.linear(f"{name}.out", y.transpose(1, 2).reshape(b, tq, dim))

    def aifi(self, x, pos):
        """Post-norm transformer layer; departure: tanh-approximate GELU."""
        q = self.prec.act(x + pos)
        x = self.layer_norm("encoder.aifi.LayerNorm_0",
                            x + self.attention("encoder.aifi.self_attn", q, q, x))
        y = self.linear("encoder.aifi.Dense_1",
                        F.gelu(self.linear("encoder.aifi.Dense_0", x), approximate="tanh"))
        return self.layer_norm("encoder.aifi.LayerNorm_1", x + y)

    def encoder(self, c3, c4, c5):
        self.part = "encoder"
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        proj = [self.conv_bn_silu(f"encoder.in_proj{i}", f, act=False)
                for i, f in enumerate((c3, c4, c5))]
        b, c, h5, w5 = proj[2].shape
        tokens = self.aifi(proj[2].flatten(2).transpose(1, 2), sincos_2d(h5, w5, c, c5.device))
        p5 = tokens.transpose(1, 2).reshape(b, c, h5, w5)
        td4 = self.plain_stage("encoder.td4", torch.cat([up(p5), proj[1]], 1))
        td3 = self.plain_stage("encoder.td3", torch.cat([up(td4), proj[0]], 1))
        bu4 = self.plain_stage("encoder.bu4",
                               torch.cat([self.conv_bn_silu("encoder.down3", td3, 2), td4], 1))
        bu5 = self.plain_stage("encoder.bu5",
                               torch.cat([self.conv_bn_silu("encoder.down4", bu4, 2), p5], 1))
        return [td3, bu4, bu5]

    # -- decoder -----------------------------------------------------------------
    def deformable(self, name: str, query, ref, memory, level_shapes, capture=None):
        """Multi-scale deformable cross-attention: values from the memory,
        per query NH·L·P sampling points at ``ref``'s centre plus offsets
        scaled by its size (offset / P · wh · 0.5), softmaxed weights over
        each head's L·P points, bilinear sampling by ``F.grid_sample``."""
        b, q, dim = query.shape
        nh, npt = self.cfg["num_heads"], self.cfg["num_points"]
        nl, hd = len(level_shapes), dim // nh
        v = self.linear(f"{name}.value_proj", memory).view(b, -1, nh, hd)
        off = self.linear(f"{name}.sampling_offsets", query, act=False).view(b, q, nh, nl, npt, 2)
        attn = torch.softmax(self.linear(f"{name}.attention_weights", query, act=False)
                             .view(b, q, nh, nl * npt), -1).view(b, q, nh, nl, npt)
        loc = ref[:, :, None, None, None, 0:2] + off / npt * ref[:, :, None, None, None, 2:4] * 0.5
        if capture is not None:
            capture.append((loc.detach(), attn.detach()))
        self.count(2.0 * 4 * hd * attn.numel())
        sampled = []
        sizes = [h * w for h, w in level_shapes]
        for lvl, (v_l, (h, w)) in enumerate(zip(v.split(sizes, dim=1), level_shapes)):
            v_l = v_l.permute(0, 2, 3, 1).reshape(b * nh, hd, h, w)
            g = (2 * loc[:, :, :, lvl] - 1).permute(0, 2, 1, 3, 4).reshape(b * nh, q, npt, 2)
            sampled.append(F.grid_sample(v_l, g, mode="bilinear", padding_mode="zeros",
                                         align_corners=False))          # (B·NH, hd, Q, P)
        s = torch.stack(sampled, -2)                                     # (B·NH, hd, Q, L, P)
        a = attn.permute(0, 2, 1, 3, 4).reshape(b * nh, 1, q, nl, npt)
        out = (s * a).sum((-1, -2)).view(b, nh, hd, q).permute(0, 3, 1, 2).reshape(b, q, dim)
        return self.linear(f"{name}.output_proj", self.prec.act(out))

    def decoder_layer(self, li: int, query, pos, ref, memory, level_shapes, mask, capture):
        name = f"decoder{li}"
        q = self.prec.act(query + pos)
        query = self.layer_norm(f"{name}.LayerNorm_0",
                                query + self.attention(f"{name}.self_attn", q, q, query, mask))
        cross = self.deformable(f"{name}.cross_attn", self.prec.act(query + pos), ref, memory,
                                level_shapes, capture)
        query = self.layer_norm(f"{name}.LayerNorm_1", query + cross)
        y = self.linear(f"{name}.Dense_1", F.relu(self.linear(f"{name}.Dense_0", query)))
        return self.layer_norm(f"{name}.LayerNorm_2", query + y)


def denoising_queries(gt_cxcywh, shift_u, scale_u, num_groups: int, num_matching: int,
                      noise: float = 1.0):
    """Contrastive denoising queries from given draws (``shift_u`` in
    [−1, 1), ``scale_u`` in [−0.5, 0.5), each (B, 2G, M, 2)). Departure: 2
    static groups over every ground-truth slot, each a positive half (shift
    under half the size, scale 1 ± 0.25) and a negative half (shift of a
    half to one size, scale 1 ± 0.5); the published model makes 100 queries
    from the image's boxes with label noise. Returns the reference boxes
    (B, 2G·M, 4), which slots are positive, and the self-attention mask
    (matching queries see no denoising query, groups see only themselves)."""
    b, m, _ = gt_cxcywh.shape
    boxes = gt_cxcywh[:, None].expand(b, 2 * num_groups, m, 4)
    is_pos = torch.arange(2 * num_groups, device=gt_cxcywh.device) % 2 == 0
    pos = is_pos[None, :, None, None]
    mag = torch.where(pos, shift_u.abs() * 0.5, 0.5 + shift_u.abs() * 0.5)
    shift = torch.sign(shift_u) * mag * boxes[..., 2:4] * noise
    scale = scale_u * noise
    wh_scale = torch.where(pos, 1.0 + 0.5 * scale, 1.0 + scale)
    dn_ref = torch.cat([boxes[..., 0:2] + shift, boxes[..., 2:4] * wh_scale.abs()], -1)
    dn_ref = dn_ref.clamp(1e-4, 1 - 1e-4).reshape(b, 2 * num_groups * m, 4)
    dev = gt_cxcywh.device
    group = torch.cat([torch.arange(num_groups, device=dev).repeat_interleave(2 * m),
                       torch.full((num_matching,), num_groups + 1, device=dev)])
    match = group == num_groups + 1
    mask = (group[:, None] == group[None, :]) | ((~match)[:, None] & match[None, :])
    return dn_ref, is_pos.repeat_interleave(m), mask


def gt_to_cxcywh(gt_boxes, img_h: int, img_w: int):
    """Pixel xyxy → normalised cxcywh."""
    n = gt_boxes / torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                                device=gt_boxes.device)
    return torch.stack([(n[..., 0] + n[..., 2]) / 2, (n[..., 1] + n[..., 3]) / 2,
                        n[..., 2] - n[..., 0], n[..., 3] - n[..., 1]], -1)


def forward_float(weights: dict, cfg: dict, x, *, train: bool = False,
                  prec: "Prec | None" = None, topk=None, gt_boxes=None, gt_mask=None,
                  dn_draws=None, batch_stats: "dict | None" = None, remat: bool = False,
                  counter: "Counter | None" = None, capture: "list | None" = None) -> dict:
    """NHWC float images in [0, 1] → the detector's outputs, as the port's
    model gives them: the final ``pred_logits`` and ``pred_boxes``
    (normalised cxcywh), ``aux_outputs`` of the earlier decoder layers,
    ``enc_outputs`` (the selected anchors' encoder logits and boxes),
    ``boxes`` (xyxy pixels) and ``cls_logits``; besides, ``enc_logits`` over
    every anchor and ``topk``, the selection used. ``topk`` (B, Q) gives the
    selection instead of the reference's own. In training with ground
    truth and ``dn_draws`` the denoising queries are added and their
    layers returned in ``dn_outputs``. ``capture`` receives each decoder
    layer's sampling locations and weights."""
    net = Net(weights, cfg, train=train, prec=prec, counter=counter, remat=remat)
    if batch_stats is not None:
        net.batch_stats = batch_stats
    b, img_h, img_w, _ = x.shape
    feats = net.encoder(*net.backbone(x.permute(0, 3, 1, 2)))
    level_shapes = [tuple(f.shape[2:]) for f in feats]
    memory = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)    # (B, ΣHW, C)
    c = memory.shape[-1]
    nq = cfg["num_queries"]

    # IoU-aware query selection. Departure (the repository's model): the
    # heads read the memory directly, with no output projection and norm.
    net.part = "select"
    enc_logits = net.linear("enc_score", memory, act=False)
    anc, valid = anchors(level_shapes, memory.device)
    enc_boxes = torch.sigmoid(net.mlp("enc_bbox", memory, 3) + anc[None])
    if topk is None:
        scores = enc_logits.max(-1).values.masked_fill(~valid[None], -1e9)
        topk = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :nq]
    ref_boxes = torch.gather(enc_boxes, 1, topk[..., None].expand(-1, -1, 4))
    enc_topk_logits = torch.gather(enc_logits, 1,
                                   topk[..., None].expand(-1, -1, enc_logits.shape[-1]))
    content = torch.gather(memory, 1, topk[..., None].expand(-1, -1, c))
    query = net.mlp("query_proj", content.detach(), 2)
    ref = ref_boxes.detach()

    num_dn, mask, dn_is_pos = 0, None, None
    if train and gt_boxes is not None and dn_draws is not None:
        gt = gt_to_cxcywh(gt_boxes, img_h, img_w).clamp(1e-4, 1 - 1e-4)
        dn_ref, dn_is_pos, mask = denoising_queries(gt, *dn_draws, cfg["num_denoising_groups"], nq)
        num_dn = dn_ref.shape[1]
        query = torch.cat([weights["dn_content_embed"].expand(b, num_dn, c), query], 1)
        ref = torch.cat([dn_ref, ref], 1)

    net.part = "decoder"
    aux, dn_out = [], []
    for li in range(cfg["num_decoder_layers"]):
        pos = net.mlp(f"ref_embed{li}", ref, 2)
        query = net.decoder_layer(li, query, pos, ref, memory, level_shapes, mask, capture)
        ref_out = torch.sigmoid(net.mlp(f"bbox_head{li}", query, 3) + inverse_sigmoid(ref))
        logits = net.linear(f"cls_head{li}", query, act=False)
        aux.append({"pred_logits": logits[:, num_dn:], "pred_boxes": ref_out[:, num_dn:]})
        if num_dn:
            dn_out.append({"pred_logits": logits[:, :num_dn], "pred_boxes": ref_out[:, :num_dn]})
        ref = ref_out.detach()

    pb = aux[-1]["pred_boxes"]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=pb.device)
    out = {"pred_logits": aux[-1]["pred_logits"], "pred_boxes": pb, "aux_outputs": aux[:-1],
           "enc_outputs": {"pred_logits": enc_topk_logits, "pred_boxes": ref_boxes},
           "boxes": cxcywh_to_xyxy(pb * scale), "cls_logits": aux[-1]["pred_logits"],
           "enc_logits": enc_logits, "topk": topk}
    if num_dn:
        out.update(dn_outputs=dn_out, dn_is_pos=dn_is_pos)
    return out


def forward(weights: dict, cfg: dict, images_u8, **kw) -> dict:
    """uint8 NHWC images → the outputs, as the port's model gives them for
    ``images / 255``."""
    return forward_float(weights, cfg, images_u8.float() / 255.0, **kw)


# -- the set loss ------------------------------------------------------------------
def matched_layers(out: dict) -> list:
    """The sets the matcher assigns, in the loss's order: the encoder's
    selection, every decoder layer but the last, the last."""
    return [out["enc_outputs"]] + list(out["aux_outputs"]) + [
        {"pred_logits": out["pred_logits"], "pred_boxes": out["pred_boxes"]}]


def match_cost(logits, boxes, gt_cxcywh, gt_labels, gt_mask, *, alpha: float = 0.25,
               gamma: float = 2.0):
    """(P, Q, M) matching cost of P problems: focal class cost × 2, L1 of
    the normalised cxcywh boxes × 5, negative GIoU × 2; padded columns
    cost 1e6."""
    with torch.no_grad():
        prob = torch.sigmoid(logits.float())
        neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
        pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
        idx = gt_labels.long().clamp(0, logits.shape[-1] - 1)[:, None, :]
        idx = idx.expand(-1, logits.shape[1], -1)
        cls = torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)
        l1 = (boxes[:, :, None, :] - gt_cxcywh[:, None, :, :]).abs().sum(-1)
        g = giou(cxcywh_to_xyxy(boxes.float())[:, :, None, :],
                 cxcywh_to_xyxy(gt_cxcywh.float())[:, None, :, :])
        cost = 2.0 * cls + 5.0 * l1 - 2.0 * g
        cost = torch.where(gt_mask[:, None, :], cost, torch.full_like(cost, BIG_COST))
        return torch.nan_to_num(cost, nan=BIG_COST, posinf=BIG_COST, neginf=-BIG_COST)


def layer_costs(out: dict, gt_cxcywh, gt_labels, gt_mask):
    """The cost of every matched set of ``out``: (L·B, Q, M)."""
    layers = matched_layers(out)
    n = len(layers)
    return match_cost(torch.cat([ly["pred_logits"] for ly in layers]),
                      torch.cat([ly["pred_boxes"] for ly in layers]),
                      gt_cxcywh.repeat(n, 1, 1), gt_labels.repeat(n, 1), gt_mask.repeat(n, 1))


def assign(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """Exact minimum-cost assignment of each problem's valid columns
    (``scipy.optimize.linear_sum_assignment``); a padded column gets row 0."""
    host = cost.detach().cpu().double().numpy()
    valid = col_valid.cpu().numpy()
    out = np.zeros(valid.shape, np.int64)
    for i in range(host.shape[0]):
        cols = np.flatnonzero(valid[i])
        if cols.size:
            rows, picked = linear_sum_assignment(host[i][:, cols])
            out[i, cols[picked]] = rows
    return torch.from_numpy(out).to(cost.device)


def _vfl(logits, target, weight_mask=None):
    """BCE against the IoU target on the one class; easy negatives
    weighted by 0.75·p² (p detached)."""
    t = target[..., None]
    lg = logits.float()
    bce = lg.clamp_min(0) - lg * t + torch.log1p(torch.exp(-lg.abs()))
    w = torch.where(t > 0, t, torch.sigmoid(lg).detach() ** 2 * 0.75)
    if weight_mask is not None:
        w = w * weight_mask[..., None]
    return (bce * w).sum()


def set_loss(out: dict, gt_labels, gt_boxes, gt_mask, *, img_hw, assigned=None) -> dict:
    """The DETR set loss of ``out`` against pixel xyxy ground truth: per
    matched set VFL + 5·L1 + 2·GIoU over the matched pairs, each sum over
    the ground truth's count; plus the mean over the denoising layers of the
    same over the positive denoising queries' count. ``assigned`` (L, B, M)
    replaces the matcher's own. Returns ``loss``, ``assigned`` and ``cost``."""
    gt = gt_to_cxcywh(gt_boxes, *img_hw)
    layers = matched_layers(out)
    n, b = len(layers), gt_mask.shape[0]
    cost = layer_costs(out, gt, gt_labels, gt_mask)
    if assigned is None:
        assigned = assign(cost, gt_mask.repeat(n, 1)).view(n, b, -1)
    num_gt = gt_mask.sum().float().clamp_min(1.0)
    maskf = gt_mask.float()
    total = torch.zeros((), device=gt_mask.device)
    rows = torch.arange(b, device=gt_mask.device)[:, None]
    for li, ly in enumerate(layers):
        a = assigned[li]
        matched = ly["pred_boxes"][rows, a]
        l1 = (matched - gt).abs().sum(-1)
        g = giou(cxcywh_to_xyxy(matched.float()), cxcywh_to_xyxy(gt.float()))
        iou = g.clamp(0.0, 1.0).detach() * maskf
        target = torch.zeros(ly["pred_logits"].shape[:2], device=gt.device).scatter_reduce(
            1, a, iou, reduce="amax", include_self=True)
        total = total + (_vfl(ly["pred_logits"], target) + 5.0 * (l1 * maskf).sum()
                         + 2.0 * ((1.0 - g) * maskf).sum()) / num_gt
    dn = out.get("dn_outputs") or []
    if dn:
        d = dn[0]["pred_logits"].shape[1]
        src = torch.arange(d, device=gt.device) % gt_mask.shape[1]
        tgt, valid = gt[:, src], gt_mask[:, src]
        pos = (valid & out["dn_is_pos"][None]).float()
        num_pos = pos.sum().clamp_min(1.0)
        dn_total = torch.zeros((), device=gt.device)
        for ly in dn:
            l1 = (ly["pred_boxes"] - tgt).abs().sum(-1)
            g = giou(cxcywh_to_xyxy(ly["pred_boxes"].float()), cxcywh_to_xyxy(tgt.float()))
            iou = g.clamp(0.0, 1.0).detach() * pos
            dn_total = dn_total + (_vfl(ly["pred_logits"], iou, valid.float())
                                   + 5.0 * (l1 * pos).sum() + 2.0 * ((1.0 - g) * pos).sum()) / num_pos
        total = total + dn_total / len(dn)
    return {"loss": total, "assigned": assigned, "cost": cost}


# -- the training step ---------------------------------------------------------------
def denoise_generator(seed: int, step: int, device) -> torch.Generator:
    """The trainer's rule for a step's denoising draws (stream 1)."""
    return torch.Generator(device=device).manual_seed(((seed + 7919) << 32) + 2 * step + 1)


def denoise_draws(b: int, slots: int, groups: int, gen: torch.Generator, device):
    shape = (b, 2 * groups, slots, 2)
    shift = torch.rand(shape, generator=gen, device=gen.device) * 2 - 1
    scale = torch.rand(shape, generator=gen, device=gen.device) - 0.5
    return shift.to(device), scale.to(device)


def decayed(name: str, t: torch.Tensor) -> bool:
    """Weight decay reaches Linear and convolution kernels (rank above 1)."""
    return name.endswith(".weight") and t.dim() > 1


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, mu: dict, nu: dict, ema: dict, step: int,
               hp: dict) -> dict:
    """One update in place, ``step`` counted from 0: the gradients clipped
    to a global norm of 10 (``g / ‖g‖ · 10`` where ‖g‖ ≥ 10), AdamW's moments
    with bias correction in float32, decoupled weight decay on kernels, the
    learning rate of the warmup schedule (0 at the first update), then the
    EMA. Returns the clipped gradients."""
    f32 = np.float32
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in grads.values()]))
    if not bool(norm < GRAD_CLIP):
        grads = {k: g / norm * GRAD_CLIP for k, g in grads.items()}
    lr = ref_train.lr_at(step, hp["lr0"], hp["lrf"], hp["warmup_steps"], hp["total_steps"])
    c1 = float(1 - f32(ADAM_B1) ** f32(step + 1))
    c2 = float(1 - f32(ADAM_B2) ** f32(step + 1))
    for k, p in params.items():
        g = grads[k]
        mu[k] = mu[k] * ADAM_B1 + g * (1 - ADAM_B1)
        nu[k] = nu[k] * ADAM_B2 + g * g * (1 - ADAM_B2)
        u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
        if decayed(k, p):
            u = u + p * hp["weight_decay"]
        p.add_(u * -lr)
    decay = f32(0.9999) * (f32(1) - np.exp(-f32(step + 1) / f32(2000.0)))
    keep, take = float(decay), float(f32(1) - decay)
    for k, p in params.items():
        ema[k] = ema[k] * keep + p.detach() * take
    return {k: g.clone() for k, g in grads.items()}


def train_steps(weights: dict, cfg: dict, batches: list, *, hp: dict, draw_seed: int,
                img_hw, prec: "Prec | None" = None, topk: "list | None" = None,
                assigned: "list | None" = None, remat: bool = True) -> dict:
    """Run ``len(batches)`` protocol steps from ``weights``: /255, HSV
    jitter and flip (the trainer's draws), the forward in train mode with
    the denoising queries (the trainer's draws), the set loss, autograd's
    gradients, then ``clip_by_global_norm(10)`` and AdamW (β 0.9, 0.999, eps
    1e-8, decoupled weight decay on kernels) under the warmup schedule
    (departure: one learning rate for every tensor, the published recipe
    gives the backbone a tenth and clips at 0.1), and the EMA with its
    ``0.9999·(1 − exp(−step/2000))`` ramp. ``topk[s]`` and ``assigned[s]``,
    where given, replace step s's own selection and assignment. Returns the
    losses, the first gradient after the clip, every parameter's change
    and its EMA's, the first step's final logits and boxes, and each step's
    own assignment and cost."""
    names = [k for k in weights if is_param(k)]
    params = {k: weights[k].detach().float().clone().requires_grad_(True) for k in names}
    start = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    res = {"losses": [], "first_grad": None, "first_outputs": None, "assigned": [],
           "cost": [], "outputs": []}
    for step, batch in enumerate(batches):
        dev = batch["image"].device
        b = batch["image"].shape[0]
        aug = ref_train.augment_draws(b, ref_train.step_generator(draw_seed, step, dev), dev)
        images, gt_boxes = ref_train.augment(batch["image"].float() / 255.0, batch["gt_boxes"], aug)
        dn = denoise_draws(b, batch["gt_mask"].shape[1], cfg["num_denoising_groups"],
                           denoise_generator(draw_seed, step, dev), dev)
        wts = dict(weights)
        wts.update(params)
        out = forward_float(wts, cfg, images, train=True, prec=prec,
                            topk=None if topk is None else topk[step], gt_boxes=gt_boxes,
                            gt_mask=batch["gt_mask"], dn_draws=dn, remat=remat)
        if res["first_outputs"] is None:
            res["first_outputs"] = (out["pred_logits"].detach(), out["pred_boxes"].detach())
        own = set_loss(out, batch["gt_labels"], gt_boxes, batch["gt_mask"], img_hw=img_hw)
        res["assigned"].append(own["assigned"])
        res["cost"].append(own["cost"])
        res["outputs"].append({"gt_boxes": gt_boxes, "topk": out["topk"]})
        total = own["loss"]
        if assigned is not None and assigned[step] is not None:
            total = set_loss(out, batch["gt_labels"], gt_boxes, batch["gt_mask"], img_hw=img_hw,
                             assigned=assigned[step])["loss"]
        grads = torch.autograd.grad(total, [params[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k])).detach()
                 for k, g in zip(names, grads)}
        res["losses"].append(float(total.detach()))
        del out, own, total
        clipped = adamw_step(params, grads, mu, nu, ema, step, hp)
        if res["first_grad"] is None:
            res["first_grad"] = clipped
    res["delta"] = {k: params[k].detach() - start[k] for k in names}
    res["ema_delta"] = {k: ema[k] - start[k] for k in names}
    return res


def count_flops(cfg: dict, batch: int, img_h: int, img_w: int, weight_shapes: dict, *,
                denoising_slots: int = 0) -> Counter:
    """Model FLOPs of one forward over ``batch`` images, walked on the
    ``meta`` device from the weights' shapes; ``denoising_slots`` > 0 adds
    the training forward's 2·G·slots denoising queries."""
    counter = Counter()
    meta = {k: torch.empty(s, device="meta") for k, s in weight_shapes.items()}
    x = torch.empty((batch, img_h, img_w, 3), device="meta")
    kw = {}
    if denoising_slots:
        g = cfg["num_denoising_groups"]
        shape = (batch, 2 * g, denoising_slots, 2)
        kw = dict(train=True, gt_boxes=torch.empty((batch, denoising_slots, 4), device="meta"),
                  gt_mask=torch.empty((batch, denoising_slots), dtype=torch.bool, device="meta"),
                  dn_draws=(torch.empty(shape, device="meta"), torch.empty(shape, device="meta")))
    with torch.no_grad():
        forward_float(meta, cfg, x, counter=counter, **kw)
    return counter
