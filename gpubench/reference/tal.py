"""Frozen copy of the port's YOLO detection loss (task-aligned assignment,
BCE, CIoU, DFL) and of the box geometry it uses, in plain PyTorch, for the
training reference. The losses' definitions are the repository's own
(Ultralytics' TAL with the JAX package's tie rules); only the one-process
path is kept.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .nms import pairwise_iou

REG_MAX = 16
BOX_EPS = 1e-7


def stable_topk(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, descending, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _area(boxes):
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def elementwise_ciou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Complete IoU of aligned boxes; the aspect weight is a constant for the gradient."""
    lt = torch.maximum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    rb = torch.minimum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (_area(boxes_a) + _area(boxes_b) - inter + BOX_EPS)
    ctr_a = (boxes_a[..., 0:2] + boxes_a[..., 2:4]) * 0.5
    ctr_b = (boxes_b[..., 0:2] + boxes_b[..., 2:4]) * 0.5
    rho2 = ((ctr_a - ctr_b) ** 2).sum(-1)
    lt = torch.minimum(boxes_a[..., 0:2], boxes_b[..., 0:2])
    rb = torch.maximum(boxes_a[..., 2:4], boxes_b[..., 2:4])
    diag2 = ((rb - lt) ** 2).sum(-1) + BOX_EPS
    wh_a = (boxes_a[..., 2:4] - boxes_a[..., 0:2]).clamp_min(BOX_EPS)
    wh_b = (boxes_b[..., 2:4] - boxes_b[..., 0:2]).clamp_min(BOX_EPS)
    v = (4.0 / (math.pi ** 2)) * (
        torch.atan(wh_b[..., 0] / wh_b[..., 1]) - torch.atan(wh_a[..., 0] / wh_a[..., 1])
    ) ** 2
    alpha = (v / (1.0 - iou + v + BOX_EPS)).detach()
    return iou - rho2 / diag2 - alpha * v


ALPHA = 0.5
BETA = 6.0
TOPK = 10
EPS = 1e-9

BOX_GAIN = 7.5
CLS_GAIN = 0.5
DFL_GAIN = 1.5


class AssignResult(NamedTuple):
    target_boxes: torch.Tensor   # (B, A, 4)
    target_scores: torch.Tensor  # (B, A, nc) soft targets
    fg_mask: torch.Tensor        # (B, A) bool


@torch.no_grad()
def assign_targets(
    pred_scores: torch.Tensor,    # (B, A, nc) sigmoid probabilities
    pred_boxes: torch.Tensor,     # (B, A, 4) xyxy pixels
    anchor_points: torch.Tensor,  # (A, 2) pixels
    gt_labels: torch.Tensor,      # (B, M) int
    gt_boxes: torch.Tensor,       # (B, M, 4) xyxy pixels
    gt_mask: torch.Tensor,        # (B, M) bool
) -> AssignResult:
    """Dense task-aligned assignment over the whole batch."""
    b, a, nc = pred_scores.shape
    m = gt_boxes.shape[1]
    gt_labels = gt_labels.long().clamp(0, nc - 1)
    gt_mask = gt_mask.bool()

    # Anchor centres inside GT boxes: (B, M, A).
    ap = anchor_points[None, None]
    lt = ap - gt_boxes[:, :, None, 0:2]
    rb = gt_boxes[:, :, None, 2:4] - ap
    in_gt = torch.minimum(lt.amin(-1), rb.amin(-1)) > EPS
    valid = in_gt & gt_mask[:, :, None]

    ious = pairwise_iou(gt_boxes, pred_boxes).clamp(0.0, 1.0)          # (B, M, A)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1,
                             gt_labels[:, :, None].expand(b, m, a))     # (B, M, A)
    metric = torch.where(valid, cls_score ** ALPHA * ious ** BETA, 0.0)

    # Top-k per GT → candidate mask (B, M, A) by one scatter. Strictly
    # positive, not an epsilon: anchors outside the GT are exactly 0.
    topk_vals, topk_idx = stable_topk(metric, min(TOPK, a))
    cand = torch.zeros((b, m, a), dtype=torch.bool, device=metric.device)
    cand.scatter_(2, topk_idx, topk_vals > 0)
    cand &= valid

    # An anchor claimed by several GTs keeps the highest-IoU one (argmax:
    # the first index among equal IoUs).
    claimed = cand.sum(1)                                               # (B, A)
    best_gt = torch.where(cand, ious, -1.0).argmax(1)                   # (B, A)
    keep = torch.arange(m, device=cand.device)[None, :, None] == best_gt[:, None, :]
    cand = torch.where((claimed > 1)[:, None, :], cand & keep, cand)

    fg_mask = cand.any(1)                                               # (B, A)
    assigned_gt = cand.to(torch.uint8).argmax(1)                        # valid where fg
    target_boxes = torch.gather(gt_boxes, 1, assigned_gt[..., None].expand(b, a, 4))
    target_labels = torch.gather(gt_labels, 1, assigned_gt)

    # Normalised align metric per GT (its best anchor → its best IoU). A
    # relative floor, not an additive epsilon, for the ~1e-12 cold start.
    metric_cand = torch.where(cand, metric, 0.0)
    per_gt_max_metric = metric_cand.amax(-1, keepdim=True)
    per_gt_max_iou = torch.where(cand, ious, 0.0).amax(-1, keepdim=True)
    norm = metric_cand * per_gt_max_iou / per_gt_max_metric.clamp_min(1e-30)
    anchor_score = norm.amax(1)                                         # (B, A)

    target_scores = F.one_hot(target_labels, nc).to(anchor_score.dtype) * anchor_score[..., None]
    target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)
    return AssignResult(target_boxes, target_scores, fg_mask)


def _dfl_loss(box_logits: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy to the two bins around the
    target. ``box_logits`` (..., 4, REG_MAX), ``target_ltrb`` (..., 4) in
    stride units; the mean over the 4 sides."""
    t = target_ltrb.clamp(0.0, REG_MAX - 1 - 0.01)
    tl = torch.floor(t)
    tr = tl + 1.0
    wl = tr - t
    wr = t - tl
    logp = F.log_softmax(box_logits, dim=-1)
    ll = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr.long()[..., None])[..., 0]
    return -(wl * ll + wr * lr).mean(-1)


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy (soft targets)."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def yolo_loss(outputs: "Dict[str, torch.Tensor]", gt_labels: torch.Tensor,
              gt_boxes: torch.Tensor, gt_mask: torch.Tensor
              ) -> "Tuple[torch.Tensor, Dict[str, torch.Tensor]]":
    """Total detection loss from the YOLO outputs and padded ground truth;
    the assignment sees detached scores and boxes."""
    cls_logits = outputs["cls_logits"]
    box_logits = outputs["box_logits"]
    pred_boxes = outputs["boxes"]
    anchor_points = outputs["anchor_points"]
    anchor_strides = outputs["anchor_strides"]

    pred_scores = torch.sigmoid(cls_logits)
    assign = assign_targets(pred_scores.detach(), pred_boxes.detach(), anchor_points,
                            gt_labels, gt_boxes, gt_mask)
    # Classification: BCE against the soft targets over all anchors.
    cls_sum = optax_sigmoid_bce(cls_logits, assign.target_scores).sum()

    # Box losses on foreground anchors, weighted by the target score.
    weight = assign.target_scores.sum(-1)                               # (B, A)
    ciou = elementwise_ciou(pred_boxes, assign.target_boxes)
    box_sum = ((1.0 - ciou) * weight * assign.fg_mask).sum()

    # DFL to the assigned box as ltrb distances in stride units.
    t_lt = (anchor_points[None] - assign.target_boxes[..., 0:2]) / anchor_strides[None]
    t_rb = (assign.target_boxes[..., 2:4] - anchor_points[None]) / anchor_strides[None]
    target_ltrb = torch.cat([t_lt, t_rb], dim=-1)
    logits4 = box_logits.reshape(box_logits.shape[:-1] + (4, REG_MAX))
    dfl = _dfl_loss(logits4, target_ltrb)
    dfl_sum = (dfl * weight * assign.fg_mask).sum()

    target_sum = assign.target_scores.sum()
    num_fg = assign.fg_mask.sum()
    target_sum = target_sum.clamp_min(1.0)
    cls_loss = cls_sum / target_sum
    box_loss = box_sum / target_sum
    dfl_loss = dfl_sum / target_sum

    total = BOX_GAIN * box_loss + CLS_GAIN * cls_loss + DFL_GAIN * dfl_loss
    metrics = {"loss": total, "box_loss": box_loss, "cls_loss": cls_loss,
               "dfl_loss": dfl_loss, "num_fg": num_fg}
    return total, metrics
