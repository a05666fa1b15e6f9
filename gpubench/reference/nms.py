"""Plain reference of the serving tail: sigmoid scores, the top ``pool``
candidates above the score threshold (stable order: the lower anchor
first among equal scores), greedy NMS at IoU >= the threshold, and the
first ``max_det`` kept candidates in score order as fixed-shape arrays
(invalid rows: boxes 0, score 0, class -1).

The IoU is ``inter / ((area_a + area_b) - inter + 1e-7)`` in float32, each
step rounded on its own, the arithmetic the serving contract fixes, so
that a pair at the threshold is decided the same way on both sides.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
IOU_EPS = 1e-7


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) × (B, M, 4) xyxy → (B, N, M)."""
    aa, bb = a[..., :, None, :], b[..., None, :, :]
    lt = torch.maximum(aa[..., 0:2], bb[..., 0:2])
    rb = torch.minimum(aa[..., 2:4], bb[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        s = (x[..., 2:4] - x[..., 0:2]).clamp_min(0.0)
        return s[..., 0] * s[..., 1]

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / (union + IOU_EPS)


def serving_tail(cls_logits: torch.Tensor, boxes: torch.Tensor, *, pool: int = 512,
                 iou_threshold: float = 0.7, score_threshold: float = 0.001,
                 max_det: int = 300):
    """Single-class outputs (B, A, 1) logits and (B, A, 4) boxes → (boxes
    (B, max_det, 4), scores (B, max_det), classes (B, max_det) int32, valid
    (B, max_det) bool)."""
    scores = torch.sigmoid(cls_logits[..., 0].float())
    masked = torch.where(scores > score_threshold, scores, NEG_INF)
    k = min(pool, masked.shape[-1])
    top_scores, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes.float(), 1, idx[..., None].expand(-1, -1, 4))
    valid = top_scores > NEG_INF / 2
    overlaps = pairwise_iou(top_boxes, top_boxes) >= iou_threshold
    b = valid.shape[0]
    keep = torch.zeros_like(valid)
    removed = torch.zeros_like(valid)
    for i in range(k):
        kept = valid[:, i] & ~removed[:, i]
        keep[:, i] = kept
        removed |= overlaps[:, i, :] & kept[:, None]
    # The kept candidates in index (= score) order, then padding.
    order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    n = min(max_det, k)
    picks = torch.zeros((b, max_det), dtype=torch.long, device=keep.device)
    picks[:, :n] = order[:, :n]
    pick_valid = torch.arange(max_det, device=keep.device)[None] < keep.sum(1, keepdim=True)
    picks = torch.where(pick_valid, picks, 0)
    out_boxes = torch.gather(top_boxes, 1, picks[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, picks)
    return (torch.where(pick_valid[..., None], out_boxes, 0.0),
            torch.where(pick_valid, out_scores, 0.0),
            torch.where(pick_valid, 0, -1).to(torch.int32),
            pick_valid)
