"""Hungarian (bipartite) matching and the DETR-family set losses.

Counterpart of ``multimodal_moe_tpu/losses/hungarian.py``: the cost matrix
(focal-style class cost + L1 + GIoU, the RT-DETR recipe) is computed on the
device with static shapes; the assignment is solved on the host
(:mod:`..ops.assignment`). Padded GT columns carry a large constant cost and
are masked out of the loss. Every ``stop_gradient`` of the JAX module is a
``.detach()`` here. Under a profiler the host solve, its synchronising copy
included, is the span ``detr.match`` (counts ``problems``, L·B, and
``columns``, the valid ground truth over them; ``utils.profiler.annotate``).

Under an active mesh (``parallel.mesh.use_mesh``) each rank holds a slice
of the global batch, and :func:`detr_loss` returns the global loss, as the
JAX loss over the global batch is: every layer's numerators (the VFL, L1
and GIoU sums) and the two counts (``num_gt``, the denoising ``num_pos``)
are summed over the ranks by one differentiable ``all_reduce``, and the
counts are clamped to ≥ 1 after it. The match stays per image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.assignment import batched_lsa_assign
from ..ops.boxes import cxcywh_to_xyxy, elementwise_giou, pairwise_giou
from ..parallel.mesh import active_mesh
from ..utils.profiler import annotate

BIG_COST = 1e6


def hungarian_match(
    pred_logits: torch.Tensor,   # (B, Q, nc)
    pred_boxes: torch.Tensor,    # (B, Q, 4) cxcywh normalised
    gt_labels: torch.Tensor,     # (B, M)
    gt_boxes: torch.Tensor,      # (B, M, 4) cxcywh normalised
    gt_mask: torch.Tensor,       # (B, M) bool
    *,
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """→ (B, M) index of the query assigned to each (padded) GT slot."""
    with torch.no_grad():
        nc = pred_logits.shape[-1]
        prob = torch.sigmoid(pred_logits.float())
        neg = (1 - alpha) * (prob**gamma) * (-torch.log(1 - prob + 1e-8))
        pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
        labels = gt_labels.long().clamp(0, nc - 1)
        idx = labels[:, None, :].expand(-1, pos.shape[1], -1)           # (B, Q, M)
        cls_cost = torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)
        l1_cost = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
        giou_cost = -pairwise_giou(cxcywh_to_xyxy(pred_boxes.float()),
                                   cxcywh_to_xyxy(gt_boxes.float()))
        cost = cost_class * cls_cost + cost_bbox * l1_cost + cost_giou * giou_cost
        cost = torch.where(gt_mask[:, None, :], cost, torch.full_like(cost, BIG_COST))
        cost = torch.nan_to_num(cost, nan=BIG_COST, posinf=BIG_COST, neginf=-BIG_COST)
    with annotate("detr.match", problems=cost.shape[0]) as span:
        assigned = batched_lsa_assign(cost, gt_mask)
        if span is not None:   # only under a profiler: one more read of the mask
            span.counts["columns"] = int(gt_mask.sum())
    return assigned


def _gt_cxcywh(gt_boxes_xyxy: torch.Tensor, img_hw: "Tuple[int, int]") -> torch.Tensor:
    h, w = img_hw
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=gt_boxes_xyxy.device)
    n = gt_boxes_xyxy / scale
    return torch.stack([(n[..., 0] + n[..., 2]) / 2, (n[..., 1] + n[..., 3]) / 2,
                        n[..., 2] - n[..., 0], n[..., 3] - n[..., 1]], dim=-1)


def detr_loss(
    outputs: "Dict[str, torch.Tensor]",
    gt_labels: torch.Tensor,
    gt_boxes_xyxy: torch.Tensor,   # (B, M, 4) absolute pixels
    gt_mask: torch.Tensor,
    *,
    img_hw: "Tuple[int, int]",
    aux_weight: float = 1.0,
) -> "Tuple[torch.Tensor, Dict[str, torch.Tensor]]":
    """Set loss over the encoder head, the auxiliary and the final decoder
    layers (VFL-style BCE with IoU-aware targets + L1 + GIoU), plus the
    denoising loss where the outputs carry ``dn_outputs``."""
    gt_cxcywh = _gt_cxcywh(gt_boxes_xyxy, img_hw)
    enc_layer = outputs.get("enc_outputs")
    layers = ([enc_layer] if enc_layer is not None else []) + list(outputs["aux_outputs"]) + [
        {"pred_logits": outputs["pred_logits"], "pred_boxes": outputs["pred_boxes"]}
    ]
    # One matcher call for all L layers × B images (one host copy).
    n_layers, b = len(layers), gt_mask.shape[0]
    stack_logits = torch.stack([ly["pred_logits"] for ly in layers])
    stack_boxes = torch.stack([ly["pred_boxes"] for ly in layers])
    assigned_all = hungarian_match(
        stack_logits.reshape((n_layers * b,) + stack_logits.shape[2:]),
        stack_boxes.reshape((n_layers * b,) + stack_boxes.shape[2:]),
        gt_labels.repeat(n_layers, 1),
        gt_cxcywh.repeat(n_layers, 1, 1),
        gt_mask.repeat(n_layers, 1),
    ).reshape(n_layers, b, -1)

    # Each layer's numerators (VFL, L1, GIoU), then the denoising layers',
    # then the counts: one vector, summed over the ranks on a mesh.
    sums = [_single_layer_sums(ly["pred_logits"], ly["pred_boxes"], gt_cxcywh, gt_mask,
                               assigned_all[li]) for li, ly in enumerate(layers)]
    dn_layers = outputs.get("dn_outputs") or []
    pos = None
    if dn_layers:
        pos = _dn_positives(dn_layers[0]["pred_logits"].shape[1], outputs["dn_is_pos"], gt_mask)
        sums += [_dn_layer_sums(ly["pred_logits"], ly["pred_boxes"], pos, gt_cxcywh, gt_mask)
                 for ly in dn_layers]
    num_gt = gt_mask.sum().float()
    num_pos = pos.sum().float() if pos is not None else torch.zeros_like(num_gt)
    mesh = active_mesh()
    if mesh is not None:
        flat = mesh.all_reduce(torch.stack([t for s in sums for t in s] + [num_gt, num_pos]))
        sums = [tuple(flat[3 * i:3 * i + 3]) for i in range(len(sums))]
        num_gt, num_pos = flat[-2], flat[-1]
    num_fg = num_gt.round().long()
    num_gt, num_pos = num_gt.clamp_min(1.0), num_pos.clamp_min(1.0)

    total = torch.zeros((), device=gt_mask.device)
    metrics: "Dict[str, torch.Tensor]" = {}
    for li in range(n_layers):
        weight = 1.0 if li == n_layers - 1 else aux_weight
        cls_sum, l1_sum, giou_sum = sums[li]
        cls_loss, box_loss, giou_loss = cls_sum / num_gt, l1_sum / num_gt, giou_sum / num_gt
        total = total + weight * (cls_loss + 5.0 * box_loss + 2.0 * giou_loss)
        if li == n_layers - 1:
            metrics = {"cls_loss": cls_loss, "box_loss": box_loss, "giou_loss": giou_loss,
                       "num_fg": num_fg}

    if dn_layers:
        dn_total = torch.zeros((), device=gt_mask.device)
        for cls_sum, l1_sum, giou_sum in sums[n_layers:]:
            dn_total = dn_total + (cls_sum / num_pos + 5.0 * (l1_sum / num_pos)
                                   + 2.0 * (giou_sum / num_pos))
        dn_total = dn_total / len(dn_layers)
        total = total + dn_total
        metrics["dn_loss"] = dn_total
    metrics["loss"] = total
    return total, metrics


def _vfl_cls_loss(pred_logits, iou_target, weight_mask=None):
    """VFL-style BCE: targets are the (detached) IoU on class 0, easy
    negatives are down-weighted by 0.75·p² (detached)."""
    nc = pred_logits.shape[-1]
    one_hot = F.one_hot(torch.zeros(iou_target.shape, dtype=torch.long,
                                    device=iou_target.device), nc).float()
    target = iou_target[..., None] * one_hot
    logits = pred_logits.float()
    bce = logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    neg_w = torch.sigmoid(logits).detach() ** 2.0 * 0.75
    w = torch.where(target > 0, target, neg_w)
    if weight_mask is not None:
        w = w * weight_mask[..., None]
    return (bce * w).sum()


def _dn_positives(d_slots: int, dn_is_pos, gt_mask):
    """(B, D) the positive denoising slots: slot g2·M + j reconstructs GT
    j = slot % M, and even half-groups are positives."""
    src = torch.arange(d_slots, device=gt_mask.device) % gt_mask.shape[1]
    return gt_mask[:, src] & dn_is_pos[None, :]


def _dn_layer_sums(pred_logits, pred_boxes, pos, gt_cxcywh, gt_mask):
    """One denoising layer's numerators (VFL, L1, GIoU), each to be
    divided by the positives' count."""
    d_slots = pred_logits.shape[1]
    src = torch.arange(d_slots, device=pred_logits.device) % gt_cxcywh.shape[1]
    tgt_boxes = gt_cxcywh[:, src]                                   # (B, D, 4)
    valid = gt_mask[:, src]                                         # (B, D)

    l1 = (pred_boxes - tgt_boxes).abs().sum(-1)
    giou = elementwise_giou(cxcywh_to_xyxy(pred_boxes.float()), cxcywh_to_xyxy(tgt_boxes.float()))
    iou_t = giou.clamp(0.0, 1.0).detach() * pos
    return (_vfl_cls_loss(pred_logits, iou_t, valid), (l1 * pos).sum(),
            ((1.0 - giou) * pos).sum())


def _single_layer_sums(pred_logits, pred_boxes, gt_cxcywh, gt_mask, assigned):
    """One matched layer's numerators (VFL, L1, GIoU), each to be divided
    by the ground truth's count."""
    b, q, _ = pred_logits.shape
    batch_idx = torch.arange(b, device=pred_boxes.device)[:, None]
    matched_boxes = pred_boxes[batch_idx, assigned]                 # (B, M, 4)

    l1 = (matched_boxes - gt_cxcywh).abs().sum(-1)
    giou = elementwise_giou(cxcywh_to_xyxy(matched_boxes.float()),
                            cxcywh_to_xyxy(gt_cxcywh.float()))

    # IoU-aware targets: a matched query's target is the (detached) IoU of
    # its box; padded columns point at row 0 with IoU 0, and "amax" keeps the
    # real match's IoU there.
    iou_val = giou.clamp(0.0, 1.0).detach() * gt_mask
    iou_q = torch.zeros((b, q), device=pred_logits.device).scatter_reduce(
        1, assigned, iou_val, reduce="amax", include_self=True)
    return (_vfl_cls_loss(pred_logits, iou_q), (l1 * gt_mask).sum(),
            ((1.0 - giou) * gt_mask).sum())
