"""Hungarian (bipartite) matching and the DETR-family set losses.

Counterpart of ``multimodal_moe_tpu/losses/hungarian.py``: the cost matrix
(focal-style class cost + L1 + GIoU, the RT-DETR recipe) is computed on the
device with static shapes; the assignment is solved on the host
(:mod:`..ops.assignment`). Padded GT columns carry a large constant cost and
are masked out of the loss. Every ``stop_gradient`` of the JAX module is a
``.detach()`` here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.assignment import batched_lsa_assign
from ..ops.boxes import cxcywh_to_xyxy, elementwise_giou, pairwise_giou

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
    return batched_lsa_assign(cost, gt_mask)


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

    total = torch.zeros((), device=gt_mask.device)
    metrics: "Dict[str, torch.Tensor]" = {}
    for li, layer in enumerate(layers):
        weight = 1.0 if li == n_layers - 1 else aux_weight
        loss, m = _single_layer_loss(layer["pred_logits"], layer["pred_boxes"], gt_cxcywh,
                                     gt_mask, assigned_all[li])
        total = total + weight * loss
        if li == n_layers - 1:
            metrics = m

    dn_layers = outputs.get("dn_outputs") or []
    if dn_layers:
        dn_total = torch.zeros((), device=gt_mask.device)
        for layer in dn_layers:
            dn_total = dn_total + _dn_layer_loss(layer["pred_logits"], layer["pred_boxes"],
                                                 outputs["dn_is_pos"], gt_cxcywh, gt_mask)
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


def _dn_layer_loss(pred_logits, pred_boxes, dn_is_pos, gt_cxcywh, gt_mask):
    """Denoising loss for one decoder layer. Slot = g2·M + j reconstructs
    GT j = slot % M; even half-groups are positives."""
    d_slots = pred_logits.shape[1]
    m = gt_cxcywh.shape[1]
    src = torch.arange(d_slots, device=pred_logits.device) % m
    tgt_boxes = gt_cxcywh[:, src]                                   # (B, D, 4)
    valid = gt_mask[:, src]                                         # (B, D)
    pos = valid & dn_is_pos[None, :]
    num_pos = pos.sum().float().clamp_min(1.0)

    l1 = (pred_boxes - tgt_boxes).abs().sum(-1)
    giou = elementwise_giou(cxcywh_to_xyxy(pred_boxes.float()), cxcywh_to_xyxy(tgt_boxes.float()))
    box_loss = (l1 * pos).sum() / num_pos
    giou_loss = ((1.0 - giou) * pos).sum() / num_pos
    iou_t = giou.clamp(0.0, 1.0).detach() * pos
    cls_loss = _vfl_cls_loss(pred_logits, iou_t, valid) / num_pos
    return cls_loss + 5.0 * box_loss + 2.0 * giou_loss


def _single_layer_loss(pred_logits, pred_boxes, gt_cxcywh, gt_mask, assigned):
    b, q, _ = pred_logits.shape
    batch_idx = torch.arange(b, device=pred_boxes.device)[:, None]
    matched_boxes = pred_boxes[batch_idx, assigned]                 # (B, M, 4)
    num_gt = gt_mask.sum().float().clamp_min(1.0)

    l1 = (matched_boxes - gt_cxcywh).abs().sum(-1)
    giou = elementwise_giou(cxcywh_to_xyxy(matched_boxes.float()),
                            cxcywh_to_xyxy(gt_cxcywh.float()))
    box_loss = (l1 * gt_mask).sum() / num_gt
    giou_loss = ((1.0 - giou) * gt_mask).sum() / num_gt

    # IoU-aware targets: a matched query's target is the (detached) IoU of
    # its box; padded columns point at row 0 with IoU 0, and "amax" keeps the
    # real match's IoU there.
    iou_val = giou.clamp(0.0, 1.0).detach() * gt_mask
    iou_q = torch.zeros((b, q), device=pred_logits.device).scatter_reduce(
        1, assigned, iou_val, reduce="amax", include_self=True)
    cls_loss = _vfl_cls_loss(pred_logits, iou_q) / num_gt

    total = cls_loss + 5.0 * box_loss + 2.0 * giou_loss
    return total, {"cls_loss": cls_loss, "box_loss": box_loss, "giou_loss": giou_loss,
                   "num_fg": gt_mask.sum()}
