"""RT-DETR detector (PyTorch): ResNet-vd backbone, hybrid encoder (AIFI +
CCFF), multi-scale deformable-attention decoder with iterative box
refinement and IoU-aware query selection, NMS-free output; in training,
contrastive denoising queries.

Counterpart of ``multimodal_moe_tpu/models/rtdetr.py``. Modules carry the
Flax names (``self_attn.query``, ``cross_attn.value_proj``,
``LayerNorm_0``, ``decoder0``, ...) so that ``convert.flax_to_state_dict``
maps the tree and ``load_state_dict(strict=True)`` catches any miss. The
public input is NHWC like the JAX model's; inside, maps are NCHW and are
flattened to tokens in NHWC row-major order, the order the anchors, the
valid mask and the level offsets assume.

Float32 islands, kept in bf16 too: the softmax of the attention weights,
the sampling locations, the deformable sampling itself, encoder boxes and
scores, and the refined boxes. ``forward(train=True)`` needs train mode
(``model.train()``: Flax's batch statistics in every BatchNorm); with
ground truth it adds the denoising queries. The loss is
:func:`rtdetr_loss` (``losses/hungarian.py``).

``int8=True`` builds the PTQ serving model: the ResNet-vd backbone and the
CCFF convs (``in_proj*``, the fusion stages, ``down3``/``down4``) run on int8
codes, AIFI is an fp island (dequantized in, requantized out with
``s_aifi_0``), and the encoder's outputs are dequantized for the fp decoder.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deformable_kernel import ms_deform_attn_fwd
from ..ops.nms import stable_topk
from ..quant import QT, dequantize, q_from_images, quantize_to, record_absmax, register_quant
from .layers import MLP, CSPStage, ConvBNAct, PlainStage, concat, lecun_normal_, upsample2x
from .resnet import ResNet

LN_EPS = 1e-6  # Flax LayerNorm's epsilon (torch's default is 1e-5)
CLS_PRIOR_BIAS = -4.6


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(H·W, dim) fixed 2-D sine-cosine position embedding, computed in
    float64 and cast to float32 as the JAX function does."""
    assert dim % 4 == 0
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    quarter = dim // 4
    omega = 1.0 / (temperature ** (np.arange(quarter) / quarter))
    out = []
    for grid in (xs, ys):
        ang = grid.reshape(-1)[:, None] * omega[None]
        out += [np.sin(ang), np.cos(ang)]
    return np.concatenate(out, axis=1).astype(np.float32)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def tokens_of(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W, C), row-major over (H, W) like NHWC's reshape."""
    return x.flatten(2).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention``: ``query``/``key``/``value``
    projections to NH heads of hd = dim/NH, q scaled by 1/√hd, softmax over
    keys, ``out`` projection. ``mask`` (broadcast to (B, NH, Tq, Tk), True =
    may attend) is for the training slice's denoising queries."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, mask: "torch.Tensor | None" = None):
        b, tq, dim = q_in.shape
        tk = k_in.shape[1]
        nh, hd = self.num_heads, dim // self.num_heads
        q = self.query(q_in).view(b, tq, nh, hd).transpose(1, 2)
        k = self.key(k_in).view(b, tk, nh, hd).transpose(1, 2)
        v = self.value(v_in).view(b, tk, nh, hd).transpose(1, 2)
        q = q / math.sqrt(hd)
        logits = torch.matmul(q, k.transpose(-1, -2))          # (B, NH, Tq, Tk)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        y = torch.matmul(weights, v).transpose(1, 2).reshape(b, tq, dim)
        return self.out(y)


class EncoderLayer(nn.Module):
    """Post-norm transformer encoder layer (AIFI); tanh-approximate GELU as
    Flax's ``nn.gelu``."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 1024):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, dim)
        self.LayerNorm_1 = layer_norm(dim)

    def forward(self, x, pos):
        # JAX adds the float32 embedding in float32, then the projections
        # cast to the working type.
        q = (x.float() + pos).to(x.dtype)
        x = self.LayerNorm_0(x + self.self_attn(q, q, x))
        y = self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))
        return self.LayerNorm_1(x + y)


class HybridEncoder(nn.Module):
    """1×1 input projections, AIFI on the stride-32 map, CCFF top-down then
    bottom-up fusion → three maps at ``hidden_dim``. ``arch="tpu"`` fuses
    with full-width PlainStages, ``arch="csp"`` with CSP stages."""

    def __init__(self, in_channels: Sequence[int], hidden_dim: int = 256,
                 num_heads: int = 8, arch: str = "tpu", int8: bool = False):
        super().__init__()
        c = hidden_dim
        for i, cin in enumerate(in_channels):
            self.add_module(f"in_proj{i}", ConvBNAct(cin, c, 1, act=False, int8=int8))
        self.aifi = EncoderLayer(c, num_heads, ffn_dim=4 * c)
        for name in ("td4", "td3", "bu4", "bu5"):
            if arch == "tpu":
                self.add_module(name, PlainStage(2 * c, c, 2, shortcut=False, int8=int8))
            elif arch == "csp":
                self.add_module(name, CSPStage(2 * c, c, 3, shortcut=False, int8=int8))
            else:
                raise ValueError(f"arch must be 'tpu' or 'csp', got {arch!r}")
        self.down3 = ConvBNAct(c, c, 3, strides=2, int8=int8)
        self.down4 = ConvBNAct(c, c, 3, strides=2, int8=int8)
        if int8:
            register_quant(self, "s_aifi_0", torch.ones(()))
        self._pos: "Dict[tuple, torch.Tensor]" = {}

    def _pos_embed(self, h, w, c, device):
        key = (h, w, c, str(device))
        if key not in self._pos:
            self._pos[key] = torch.as_tensor(sincos_2d(h, w, c), device=device)[None]
        return self._pos[key]

    def forward(self, feats):
        proj = [getattr(self, f"in_proj{i}")(f) for i, f in enumerate(feats)]
        quant = isinstance(proj[2], QT)
        # AIFI is an fp island of the int8 encoder: dequantize in, requantize
        # out with a calibrated scale, so the CCFF below stays int8.
        p5_in = dequantize(proj[2]) if quant else proj[2]
        b, c, h5, w5 = p5_in.shape
        tokens = self.aifi(tokens_of(p5_in), self._pos_embed(h5, w5, c, p5_in.device))
        p5 = tokens.transpose(1, 2).reshape(b, c, h5, w5)
        if quant:
            p5 = QT(quantize_to(p5.float(), self.s_aifi_0), self.s_aifi_0)
        else:
            record_absmax(self, "aifi0_absmax", p5)
        td4 = self.td4(concat([upsample2x(p5), proj[1]]))
        td3 = self.td3(concat([upsample2x(td4), proj[0]]))
        bu4 = self.bu4(concat([self.down3(td3), td4]))
        bu5 = self.bu5(concat([self.down4(bu4), p5]))
        return [td3, bu4, bu5]


def _grid_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Directional init of the sampling-offset biases: head h points along
    angle 2πh/NH, point p at distance p+1."""
    thetas = np.arange(num_heads) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    scale = np.arange(1, num_points + 1).reshape(1, 1, num_points, 1)
    return (grid * scale).reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: projections around the sampling
    core, which is the CUDA kernels on the card (``ms_deform_attn_fwd``, an
    autograd function: forward kernel B4, backward kernel B5)."""

    def __init__(self, dim: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        n = num_heads * num_levels * num_points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, 2 * n)
        self.attention_weights = nn.Linear(dim, n)
        self.output_proj = nn.Linear(dim, dim)

    def sampling_inputs(self, query, reference_points, values):
        """The kernel's float32 inputs: values ``(B, ΣHW, NH, D)``, locations
        ``(B, Q, NH, L, P, 2)`` and attention weights ``(B, Q, NH, L, P)``."""
        b, q, dim = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(values).view(b, -1, nh, dim // nh)
        offsets = self.sampling_offsets(query).view(b, q, nh, nl, npt, 2)
        weights = torch.softmax(
            self.attention_weights(query).view(b, q, nh, -1).float(), dim=-1
        ).view(b, q, nh, nl, npt)
        # Offsets scaled by the reference box size, in float32 and in this
        # order, as JAX computes them.
        ctr = reference_points[..., None, None, None, 0:2]
        wh = reference_points[..., None, None, None, 2:4]
        loc = ctr + offsets.float() / npt * wh * 0.5
        return v.float().contiguous(), loc.contiguous(), weights.contiguous()

    def forward(self, query, reference_points, values, level_shapes):
        v, loc, weights = self.sampling_inputs(query, reference_points, values)
        out = ms_deform_attn_fwd(v, level_shapes, loc, weights)
        return self.output_proj(out.to(query.dtype))


class DecoderLayer(nn.Module):
    """Self-attention over the queries, deformable cross-attention into the
    encoder memory, ReLU FFN; post-norm."""

    def __init__(self, dim: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4, ffn_dim: int = 1024):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.LayerNorm_0 = layer_norm(dim)
        self.cross_attn = MSDeformAttn(dim, num_heads, num_levels, num_points)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, dim)
        self.LayerNorm_2 = layer_norm(dim)

    def forward(self, query, query_pos, reference_points, values, level_shapes,
                attn_mask=None):
        q = query + query_pos
        mask = None if attn_mask is None else attn_mask[None, None]
        query = self.LayerNorm_0(query + self.self_attn(q, q, query, mask))
        cross = self.cross_attn(query + query_pos, reference_points, values, level_shapes)
        query = self.LayerNorm_1(query + cross)
        y = self.Dense_1(F.relu(self.Dense_0(query)))
        return self.LayerNorm_2(query + y)


def anchors_for(level_shapes, grid_size: float = 0.05):
    """Per-location anchor priors in inverse-sigmoid space, (ΣHW, 4), and
    the mask of anchors inside (0.01, 0.99), (ΣHW,)."""
    all_anchors, valids = [], []
    for lvl, (h, w) in enumerate(level_shapes):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cx = (xs + 0.5) / w
        cy = (ys + 0.5) / h
        wh = np.full_like(cx, grid_size * (2.0**lvl))
        a = np.stack([cx, cy, wh, wh], -1).reshape(-1, 4)
        valid = ((a > 0.01) & (a < 0.99)).all(-1)
        a = np.clip(a, 0.01, 0.99)
        all_anchors.append(np.log(a / (1 - a)))
        valids.append(valid)
    return np.concatenate(all_anchors).astype(np.float32), np.concatenate(valids)


def build_denoising_queries(
    gt_boxes: torch.Tensor,    # (B, M, 4) cxcywh normalised
    gt_mask: torch.Tensor,     # (B, M)
    *,
    num_groups: int = 2,
    num_matching: int,
    box_noise_scale: float = 1.0,
    generator: "torch.Generator | None" = None,
    shift_u: "torch.Tensor | None" = None,
    scale_u: "torch.Tensor | None" = None,
):
    """Contrastive denoising (CDN) queries, static shapes (the JAX function).

    Per group every GT slot yields a positive query (small jitter) and a
    negative one (large jitter). The uniform draws ``shift_u`` in [−1, 1)
    and ``scale_u`` in [−0.5, 0.5), each ``(B, 2G, M, 2)``, come from
    ``generator`` unless given (the tests feed JAX's).

    Returns ``dn_ref`` (B, D, 4) in [0, 1], ``dn_is_pos`` (D,) bool and the
    attention mask (D+Q, D+Q) bool, True = may attend; D = 2·G·M.
    """
    b, m, _ = gt_boxes.shape
    d = 2 * num_groups * m
    dev = gt_boxes.device
    boxes = gt_boxes[:, None].expand(b, 2 * num_groups, m, 4)       # (B, 2G, M, 4)
    is_pos = torch.arange(2 * num_groups, device=dev) % 2 == 0
    draw_on = generator.device if generator is not None else dev
    if shift_u is None:
        shift_u = torch.rand((b, 2 * num_groups, m, 2), generator=generator, device=draw_on) * 2 - 1
    if scale_u is None:
        scale_u = torch.rand((b, 2 * num_groups, m, 2), generator=generator, device=draw_on) - 0.5
    shift_u, scale_u = shift_u.to(dev), scale_u.to(dev) * box_noise_scale
    pos = is_pos[None, :, None, None]
    # positive: shift in (−0.5, 0.5)·wh; negative: ±(0.5, 1.0)·wh
    mag = torch.where(pos, shift_u.abs() * 0.5, 0.5 + shift_u.abs() * 0.5)
    shift = torch.sign(shift_u) * mag * boxes[..., 2:4] * box_noise_scale
    wh_scale = torch.where(pos, 1.0 + 0.5 * scale_u, 1.0 + scale_u)
    ctr = boxes[..., 0:2] + shift
    wh = boxes[..., 2:4] * wh_scale.abs()
    dn_ref = torch.cat([ctr, wh], -1).clamp(1e-4, 1.0 - 1e-4).reshape(b, d, 4)
    dn_is_pos = is_pos.repeat_interleave(m)                          # (D,)
    # Matching queries never see dn queries, dn groups never see each other,
    # dn queries may see the matching queries (RT-DETRv2/DINO).
    group_id = torch.cat([
        torch.arange(num_groups, device=dev).repeat_interleave(2 * m),
        torch.full((num_matching,), num_groups + 1, device=dev),
    ])
    is_match = group_id == num_groups + 1
    attn_mask = (group_id[:, None] == group_id[None, :]) | ((~is_match)[:, None] & is_match[None, :])
    return dn_ref, dn_is_pos, attn_mask


class RTDETRDetector(nn.Module):
    """Full RT-DETR. ``forward(images)`` takes NHWC float images in [0, 1]
    and returns the JAX model's output dict: final ``pred_logits``/
    ``pred_boxes`` (normalised cxcywh), ``aux_outputs`` of the earlier
    decoder layers, ``enc_outputs`` of the query selection, and ``boxes``
    (xyxy pixels) + ``cls_logits`` for the serving tail; in training with
    ground truth also ``dn_outputs``, ``dn_is_pos`` and ``dn_groups``.

    ``dtype`` is the compute (and weight) type. Weights are initialised as
    Flax initialises them, from ``generator``. ``remat`` recomputes the
    backbone blocks during backward.
    """

    denoising_capable = True  # the trainer passes ground truth and denoising draws

    def __init__(self, num_classes: int = 1, hidden_dim: int = 256, num_queries: int = 300,
                 num_decoder_layers: int = 6, num_heads: int = 8, num_points: int = 4,
                 num_denoising_groups: int = 2,
                 backbone_depths: "Tuple[int, ...]" = (3, 4, 6, 3), arch: str = "tpu",
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 generator: "torch.Generator | None" = None, int8: bool = False):
        super().__init__()
        if int8 and dtype != torch.float32:
            raise ValueError("the int8 model keeps dtype float32 (its scales are float32)")
        c = hidden_dim
        self.int8 = int8
        self.num_classes, self.hidden_dim, self.num_queries = num_classes, c, num_queries
        self.num_decoder_layers = num_decoder_layers
        self.num_denoising_groups = num_denoising_groups
        self.dtype = dtype
        self.backbone = ResNet(stage_sizes=backbone_depths, remat=remat, int8=int8)
        self.encoder = HybridEncoder(self.backbone.out_channels[1:], c, num_heads, arch,
                                     int8=int8)
        self.enc_score = nn.Linear(c, num_classes)
        self.enc_bbox = MLP(c, c, 4, num_layers=3)
        self.query_proj = MLP(c, c, c, num_layers=2)
        # Content of every denoising query (training only).
        self.dn_content_embed = nn.Parameter(torch.zeros(1, 1, c))
        for li in range(num_decoder_layers):
            self.add_module(f"ref_embed{li}", MLP(4, c, c, num_layers=2))
            self.add_module(f"decoder{li}", DecoderLayer(c, num_heads, 3, num_points))
            self.add_module(f"bbox_head{li}", MLP(c, c, 4, num_layers=3))
            self.add_module(f"cls_head{li}", nn.Linear(c, num_classes))
        self._init_weights(generator, num_heads, num_points)
        self.to(dtype)
        self._anchor_cache: "Dict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = {}

    def _init_weights(self, generator, num_heads, num_points):
        grid_bias = torch.from_numpy(_grid_init(num_heads, 3, num_points))
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(mod.weight, generator)
                    if mod.bias is not None:
                        mod.bias.zero_()
                if name.endswith("sampling_offsets"):
                    mod.weight.zero_()
                    mod.bias.copy_(grid_bias)
                elif name.startswith("cls_head"):
                    mod.bias.fill_(CLS_PRIOR_BIAS)
            nn.init.trunc_normal_(self.dn_content_embed, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)

    def _anchors(self, level_shapes, device):
        key = (tuple(level_shapes), str(device))
        if key not in self._anchor_cache:
            anchors, valid = anchors_for(level_shapes)
            self._anchor_cache[key] = (torch.as_tensor(anchors, device=device),
                                       torch.as_tensor(valid, device=device))
        return self._anchor_cache[key]

    def forward(self, images: torch.Tensor, train: bool = False,
                gt_boxes: "torch.Tensor | None" = None, gt_mask: "torch.Tensor | None" = None,
                denoise_generator: "torch.Generator | None" = None,
                dn_draws: "Tuple[torch.Tensor, torch.Tensor] | None" = None) -> Dict:
        """``gt_boxes`` (B, M, 4) xyxy pixels and ``gt_mask`` (B, M) add the
        denoising queries in training; their draws come from
        ``denoise_generator``, or are ``dn_draws = (shift_u, scale_u)``."""
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a model in {'train' if self.training else 'eval'} "
                "mode: BatchNorm follows the mode, so call model.train() or model.eval() first"
            )
        b, img_h, img_w, _ = images.shape
        x = q_from_images(images) if self.int8 else images.to(self.dtype).permute(0, 3, 1, 2)
        _, c3, c4, c5 = self.backbone(x)
        feats = self.encoder([c3, c4, c5])
        if self.int8:
            feats = [dequantize(f) for f in feats]
        level_shapes = [tuple(f.shape[2:]) for f in feats]
        memory = torch.cat([tokens_of(f) for f in feats], dim=1)   # (B, ΣHW, C)

        # IoU-aware query selection from the encoder output.
        enc_logits = self.enc_score(memory).float()
        anchors, valid = self._anchors(level_shapes, memory.device)
        enc_boxes = torch.sigmoid(self.enc_bbox(memory).float() + anchors[None])
        scores = enc_logits.max(dim=-1).values
        scores = scores.masked_fill(~valid[None], -1e9)
        _, topk = stable_topk(scores, self.num_queries)             # lax.top_k's ties
        ref_boxes = torch.gather(enc_boxes, 1, topk[..., None].expand(-1, -1, 4))
        enc_topk_logits = torch.gather(
            enc_logits, 1, topk[..., None].expand(-1, -1, enc_logits.shape[-1]))
        content = torch.gather(memory, 1, topk[..., None].expand(-1, -1, memory.shape[-1]))
        query = self.query_proj(content.detach())
        ref = ref_boxes.detach()

        # Contrastive denoising queries (training with ground truth only).
        num_dn, attn_mask, dn_is_pos = 0, None, None
        if train and self.num_denoising_groups > 0 and gt_boxes is not None and gt_mask is not None:
            scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                                 device=gt_boxes.device)
            gt_n = gt_boxes / scale
            gt_cxcywh = torch.cat([(gt_n[..., 0:2] + gt_n[..., 2:4]) / 2,
                                   gt_n[..., 2:4] - gt_n[..., 0:2]], dim=-1)
            shift_u, scale_u = dn_draws if dn_draws is not None else (None, None)
            dn_ref, dn_is_pos, attn_mask = build_denoising_queries(
                gt_cxcywh.clamp(1e-4, 1 - 1e-4), gt_mask,
                num_groups=self.num_denoising_groups, num_matching=self.num_queries,
                generator=denoise_generator, shift_u=shift_u, scale_u=scale_u)
            num_dn = dn_ref.shape[1]
            dn_query = self.dn_content_embed.to(self.dtype).expand(b, num_dn, -1)
            query = torch.cat([dn_query, query], dim=1)
            ref = torch.cat([dn_ref, ref], dim=1)

        # Decoder with iterative refinement; the carried ``ref`` is detached,
        # so each layer's box loss sees only its own delta.
        aux_outputs: "List[Dict[str, torch.Tensor]]" = []
        dn_outputs: "List[Dict[str, torch.Tensor]]" = []
        for li in range(self.num_decoder_layers):
            query_pos = getattr(self, f"ref_embed{li}")(ref.to(self.dtype))
            query = getattr(self, f"decoder{li}")(query, query_pos, ref, memory, level_shapes,
                                                  attn_mask=attn_mask)
            delta = getattr(self, f"bbox_head{li}")(query)
            ref_out = torch.sigmoid(delta.float() + inverse_sigmoid(ref))
            logits = getattr(self, f"cls_head{li}")(query).float()
            aux_outputs.append({"pred_logits": logits[:, num_dn:], "pred_boxes": ref_out[:, num_dn:]})
            if num_dn:
                dn_outputs.append({"pred_logits": logits[:, :num_dn],
                                   "pred_boxes": ref_out[:, :num_dn]})
            ref = ref_out.detach()

        final = aux_outputs[-1]
        pb = final["pred_boxes"]
        cx, cy = pb[..., 0] * img_w, pb[..., 1] * img_h
        w, h = pb[..., 2] * img_w, pb[..., 3] * img_h
        boxes_xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
        out = {
            "pred_logits": final["pred_logits"],
            "pred_boxes": final["pred_boxes"],
            "aux_outputs": aux_outputs[:-1],
            # Matched as one more layer so that enc_score/enc_bbox train; the
            # boxes stay attached.
            "enc_outputs": {"pred_logits": enc_topk_logits, "pred_boxes": ref_boxes},
            "boxes": boxes_xyxy,                    # (B, Q, 4) xyxy pixels
            "cls_logits": final["pred_logits"],     # evaluator interface
        }
        if num_dn:
            out.update(dn_outputs=dn_outputs, dn_is_pos=dn_is_pos,
                       dn_groups=self.num_denoising_groups)
        return out


def rtdetr_loss(outputs, gt_labels, gt_boxes, gt_mask, *, img_hw=(704, 1248)):
    """DETR set loss incl. the encoder head and the denoising queries."""
    from ..losses.hungarian import detr_loss

    return detr_loss(outputs, gt_labels, gt_boxes, gt_mask, img_hw=img_hw)
