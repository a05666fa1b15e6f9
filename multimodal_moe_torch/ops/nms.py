"""Batched greedy NMS with fixed-shape outputs.

Counterpart of ``multimodal_moe_tpu/ops/nms.py``, with the same contract:

1. scores at or below ``score_threshold`` are masked to ``NEG_INF``;
2. the top ``K = min(num_candidates, N)`` scores per image are preselected,
   ties broken by the lower index first, as ``lax.top_k`` breaks them (a
   stable descending sort: ``torch.topk`` promises no tie order);
3. greedy suppression at IoU >= ``iou_threshold``, class-aware unless
   ``class_agnostic``;
4. fixed ``(B, max_det)`` outputs: invalid entries carry boxes 0, scores 0
   and class -1.

On a CUDA tensor the suppression is the hand-written kernel
(:func:`.nms_kernel.nms_keep_mask`) followed by a stable compaction of the
keep mask; on a CPU tensor it is :func:`_batched_nms_plain`, which mirrors
the JAX ``_single_image_nms`` scan step by step. On both, the stages are
the spans ``nms.preselect``, ``nms.keep`` and ``nms.compact`` under a
profiler (``utils.profiler.annotate``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiler import annotate
from .boxes import pairwise_iou
from .nms_kernel import nms_keep_mask

NEG_INF = -1e30


class NmsResult(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy; zeros where invalid
    scores: torch.Tensor   # (B, max_det); 0 where invalid
    classes: torch.Tensor  # (B, max_det) int32; -1 where invalid
    valid: torch.Tensor    # (B, max_det) bool


def stable_topk(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, descending, lower index first among
    ties (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _preselect(boxes, scores, classes, *, score_threshold, num_candidates):
    k = min(num_candidates, scores.shape[-1])
    masked = torch.where(scores > score_threshold, scores, NEG_INF)
    top_scores, top_idx = stable_topk(masked, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, top_idx)
    return top_boxes, top_scores, top_classes


def _finish(top_boxes, top_scores, top_classes, picks, pick_valid) -> NmsResult:
    out_boxes = torch.gather(top_boxes, 1, picks[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, picks)
    out_classes = torch.gather(top_classes, 1, picks)
    return NmsResult(
        torch.where(pick_valid[..., None], out_boxes, 0.0),
        torch.where(pick_valid, out_scores, 0.0),
        torch.where(pick_valid, out_classes, -1).to(torch.int32),
        pick_valid,
    )


def _batched_nms_plain(
    boxes, scores, classes, *, iou_threshold, score_threshold, max_det,
    num_candidates, class_agnostic, early_exit=False,
) -> NmsResult:
    """The JAX scan in plain PyTorch: each of ``max_det`` steps picks the
    first argmax of the still-alive scores and kills its overlaps. With
    ``early_exit`` the loop stops once no image has a candidate left; the
    untouched tail equals what the remaining steps would emit."""
    with annotate("nms.preselect"):
        top_boxes, top_scores, top_classes = _preselect(
            boxes, scores, classes,
            score_threshold=score_threshold, num_candidates=num_candidates,
        )
    with annotate("nms.keep"):
        b, k = top_scores.shape
        iou = pairwise_iou(top_boxes, top_boxes)
        if not class_agnostic:
            iou = torch.where(top_classes[:, :, None] == top_classes[:, None, :], iou, 0.0)
        overlaps = iou >= iou_threshold
        rows = torch.arange(b, device=boxes.device)
        cols = torch.arange(k, device=boxes.device)

        picks = torch.zeros((b, max_det), dtype=torch.long, device=boxes.device)
        pick_valid = torch.zeros((b, max_det), dtype=torch.bool, device=boxes.device)
        alive = top_scores.clone()
        for step in range(max_det):
            if early_exit and not bool((alive > NEG_INF / 2).any()):
                break
            pick = alive.argmax(dim=1)
            picked_valid = alive[rows, pick] > NEG_INF / 2
            suppress = overlaps[rows, pick] | (cols[None, :] == pick[:, None])
            alive = torch.where(suppress & picked_valid[:, None], NEG_INF, alive)
            picks[:, step] = torch.where(picked_valid, pick, 0)
            pick_valid[:, step] = picked_valid
    with annotate("nms.compact"):
        return _finish(top_boxes, top_scores, top_classes, picks, pick_valid)


def _compact(keep: torch.Tensor, max_det: int):
    """Keep mask (B, K) → the first ``max_det`` kept positions in index
    order, padded with position 0 / invalid. A stable sort puts the kept
    positions first in their own order (``torch.topk`` would not promise
    it)."""
    b, k = keep.shape
    order = torch.sort((keep == 0).to(torch.int8), dim=1, stable=True).indices
    n = min(max_det, k)
    picks = torch.zeros((b, max_det), dtype=torch.long, device=keep.device)
    picks[:, :n] = order[:, :n]
    n_keep = keep.sum(dim=1, dtype=torch.long)
    pick_valid = torch.arange(max_det, device=keep.device)[None, :] < n_keep[:, None]
    picks = torch.where(pick_valid, picks, 0)
    return picks, pick_valid


def _batched_nms_kernel(
    boxes, scores, classes, *, iou_threshold, score_threshold, max_det,
    num_candidates, class_agnostic,
) -> NmsResult:
    with annotate("nms.preselect"):
        top_boxes, top_scores, top_classes = _preselect(
            boxes, scores, classes,
            score_threshold=score_threshold, num_candidates=num_candidates,
        )
    with annotate("nms.keep"):
        keep = nms_keep_mask(
            top_boxes.contiguous(),
            (top_scores > NEG_INF / 2).to(torch.int32),
            top_classes.to(torch.int32).contiguous(),
            iou_threshold=iou_threshold,
            class_agnostic=class_agnostic,
        )
    with annotate("nms.compact"):
        picks, pick_valid = _compact(keep, max_det)
        return _finish(top_boxes, top_scores, top_classes, picks, pick_valid)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: "torch.Tensor | None" = None,
    *,
    iou_threshold: float = 0.7,
    score_threshold: float = 0.001,
    max_det: int = 300,
    num_candidates: int = 1024,
    class_agnostic: bool = False,
    topk_mode: str = "exact",
    early_exit: bool = False,
) -> NmsResult:
    """NMS over a batch: ``boxes (B, N, 4)``, ``scores (B, N)``, optional
    ``classes (B, N)`` → fixed-shape :class:`NmsResult`.

    ``topk_mode="approx"`` is accepted for the JAX signature's sake; the port
    always takes the exact top-K, which meets ``approx_max_k``'s recall
    contract. ``early_exit`` changes no result; the kernel path ignores it.
    """
    if topk_mode not in ("exact", "approx"):
        raise ValueError(f"topk_mode must be 'exact' or 'approx', got {topk_mode!r}")
    if classes is None:
        classes = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    kw = dict(
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        max_det=max_det, num_candidates=num_candidates,
        class_agnostic=class_agnostic,
    )
    if boxes.device.type == "cuda":
        return _batched_nms_kernel(boxes, scores, classes, **kw)
    if boxes.device.type == "cpu":
        return _batched_nms_plain(boxes, scores, classes, early_exit=early_exit, **kw)
    raise ValueError(f"unsupported device {boxes.device}")
