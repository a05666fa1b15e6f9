"""In-framework COCO-style detection evaluation (mAP@[.5:.95], P/R, PR curves).

The port's own copy of ``multimodal_moe_tpu/ops/coco_map.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package; on the
same inputs both return the same metrics, exactly
(``tests/test_torch_coco_map.py``).

The reference obtains these numbers from Ultralytics' validator or from
pycocotools inside RT-DETRv2, scraping them off child stdout
(ref: src/models/vision/yolo.py:204-228, rtdetr_thirdparty.py:132-155).
Here the whole evaluator is first-party so detector eval runs in-process on
TPU outputs with no third-party dependency.

Conventions follow pycocotools exactly (SURVEY.md §7 hard-part #3 — the
±0.3 mAP parity budget hinges on these details):

* IoU thresholds 0.50:0.05:0.95 (10 levels)
* 101-point interpolated precision at recall thresholds 0:0.01:1 with the
  right-to-left precision envelope
* greedy per-image matching in descending score order; each GT matched at
  most once per IoU threshold; ties prefer un-ignored GTs (GTs sorted
  ignored-last)
* area-range ignore semantics: dets matched to ignored GTs are neither TP
  nor FP; unmatched dets outside the area range are ignored
* maxDets caps applied per image before matching

On top of the pycocotools summary this evaluator also reports
Ultralytics-compatible ``precision``/``recall`` (operating point at max F1
over the confidence sweep) and PR-curve payloads matching the reference's
``curves_results`` artifact shape (ref: src/models/vision/yolo.py:269-304).

Matching is host-side numpy: eval accumulation is inherently ragged and
sequential per image, cheap next to inference, and keeping it off-device
frees the chip for the next batch. The IoU matrices that feed it can come
from the device (they're plain arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 0.50 ... 0.95
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _np_pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)×(M,4) xyxy → (N,M) IoU, numpy (host-side eval path)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), dtype=np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


@dataclass
class ImageEval:
    """Per-image matching result for one area range: parallel over dets."""

    scores: np.ndarray      # (D,)
    matched: np.ndarray     # (T, D) bool — TP at each IoU threshold
    ignored: np.ndarray     # (T, D) bool — excluded from both TP and FP
    num_gt: int             # non-ignored GT count


def match_image(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    *,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
    area_range: Tuple[float, float] = (0.0, 1e10),
    max_det: int = 100,
) -> ImageEval:
    """Greedy score-ordered matching for one image (pycocotools semantics)."""
    det_boxes = np.asarray(det_boxes, dtype=np.float64).reshape(-1, 4)
    det_scores = np.asarray(det_scores, dtype=np.float64).reshape(-1)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)

    # Sort dets by descending score (stable, like pycocotools mergesort), cap.
    order = np.argsort(-det_scores, kind="stable")[:max_det]
    det_boxes = det_boxes[order]
    det_scores = det_scores[order]
    d = det_boxes.shape[0]

    # Signed w*h, not clipped: pycocotools classifies by ann["area"] = w*h as
    # given, so a degenerate (inverted) box has negative area and falls
    # outside every range — ignored everywhere, never an FP. (Differential
    # finding from tests/test_coco_map_parity.py.)
    gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    gt_ignore = (gt_area < area_range[0]) | (gt_area > area_range[1])
    # GTs sorted un-ignored first (pycocotools sorts by ignore flag).
    gt_order = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_ignore = gt_ignore[gt_order]
    g = gt_boxes.shape[0]

    ious = _np_pairwise_iou(det_boxes, gt_boxes)
    # Signed area here too (see gt_area note above).
    det_area = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    det_outside = (det_area < area_range[0]) | (det_area > area_range[1])

    t = len(iou_thresholds)
    matched = np.zeros((t, d), dtype=bool)
    ignored = np.zeros((t, d), dtype=bool)

    for ti, thr in enumerate(iou_thresholds):
        gt_taken = np.zeros(g, dtype=bool)
        for di in range(d):
            row = ious[di]
            # Phase 1: best un-ignored available GT at/above threshold.
            cand = (~gt_taken) & (~gt_ignore) & (row >= thr)
            if cand.any():
                gi = int(np.argmax(np.where(cand, row, -1.0)))
                gt_taken[gi] = True
                matched[ti, di] = True
                continue
            # Phase 2: ignored GTs can absorb dets (det becomes ignored).
            cand = (~gt_taken) & gt_ignore & (row >= thr)
            if cand.any():
                gi = int(np.argmax(np.where(cand, row, -1.0)))
                gt_taken[gi] = True
                ignored[ti, di] = True
        # Unmatched dets outside the area range are ignored, not FP.
        ignored[ti] |= (~matched[ti]) & det_outside

    return ImageEval(
        scores=det_scores,
        matched=matched,
        ignored=ignored,
        num_gt=int((~gt_ignore).sum()),
    )


def _precision_recall_curve(
    scores: np.ndarray, matched: np.ndarray, ignored: np.ndarray, num_gt: int
):
    """Global score-sorted P/R arrays for one IoU threshold."""
    keep = ~ignored
    scores = scores[keep]
    matched = matched[keep]
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    tp = np.cumsum(matched[order])
    fp = np.cumsum(~matched[order])
    recall = tp / max(num_gt, 1)
    precision = tp / np.maximum(tp + fp, 1e-12)
    return scores, precision, recall


def _interpolated_ap(precision: np.ndarray, recall: np.ndarray) -> float:
    """101-point interpolated AP with the pycocotools precision envelope."""
    if precision.size == 0:
        return 0.0
    # Right-to-left running max (precision envelope).
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    # For each recall threshold, the first index where recall >= threshold.
    idx = np.searchsorted(recall, RECALL_THRESHOLDS, side="left")
    valid = idx < recall.size
    interp = np.zeros(RECALL_THRESHOLDS.size)
    interp[valid] = prec_env[idx[valid]]
    return float(interp.mean())


@dataclass
class CocoMetrics:
    map50_95: float
    map50: float
    map75: float
    precision: float      # at max-F1 confidence, IoU 0.5 (Ultralytics-style)
    recall: float
    ap_small: float
    ap_medium: float
    ap_large: float
    ar_1: float
    ar_10: float
    ar_100: float
    ap_per_iou: "list[float]" = field(default_factory=list)
    curves: "list[dict]" = field(default_factory=list)  # reference curves_results shape

    def to_metrics_dict(self) -> dict:
        """Flat dict with the reference's metrics.json keys
        (ref: src/models/vision/yolo.py:204-209)."""
        out = {
            "map50": self.map50,
            "map50_95": self.map50_95,
            "precision": self.precision,
            "recall": self.recall,
            "map75": self.map75,
            "ap_small": self.ap_small,
            "ap_medium": self.ap_medium,
            "ap_large": self.ap_large,
            "ar_1": self.ar_1,
            "ar_10": self.ar_10,
            "ar_100": self.ar_100,
        }
        if self.curves:
            out["curves_results"] = self.curves
        return out


def evaluate_detections(
    det_boxes: Sequence[np.ndarray],
    det_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    *,
    max_dets: Tuple[int, int, int] = (1, 10, 100),
    compute_curves: bool = True,
) -> CocoMetrics:
    """Full COCO-style evaluation over per-image detection/GT lists.

    Args:
        det_boxes / det_scores: per image, ``(Di, 4)`` xyxy + ``(Di,)`` scores
            (pass only valid rows — strip NMS padding first).
        gt_boxes: per image ``(Gi, 4)`` xyxy.
        max_dets: pycocotools maxDets triple; the last entry is the cap used
            for AP.
    """
    n_images = len(gt_boxes)
    assert len(det_boxes) == len(det_scores) == n_images
    top_max_det = max_dets[-1]

    # --- AP per area range at the top maxDet cap ---------------------------
    ap_by_range = {}
    pr_data_all = None
    for range_name, area_range in AREA_RANGES.items():
        evals = [
            match_image(
                det_boxes[i], det_scores[i], gt_boxes[i],
                area_range=area_range, max_det=top_max_det,
            )
            for i in range(n_images)
        ]
        num_gt = sum(e.num_gt for e in evals)
        scores = np.concatenate([e.scores for e in evals]) if evals else np.zeros(0)
        aps = []
        curves_at_t = []
        for ti in range(len(IOU_THRESHOLDS)):
            matched = (
                np.concatenate([e.matched[ti] for e in evals]) if evals else np.zeros(0, bool)
            )
            ignored = (
                np.concatenate([e.ignored[ti] for e in evals]) if evals else np.zeros(0, bool)
            )
            if num_gt == 0:
                aps.append(float("nan"))
                curves_at_t.append(None)
                continue
            s, p, r = _precision_recall_curve(scores, matched, ignored, num_gt)
            aps.append(_interpolated_ap(p, r))
            curves_at_t.append((s, p, r))
        ap_by_range[range_name] = aps
        if range_name == "all":
            pr_data_all = curves_at_t

    def _mean(vals: Iterable[float]) -> float:
        arr = np.asarray([v for v in vals if not np.isnan(v)])
        return float(arr.mean()) if arr.size else -1.0

    aps_all = ap_by_range["all"]
    map50_95 = _mean(aps_all)
    map50 = aps_all[0] if not np.isnan(aps_all[0]) else -1.0
    map75 = aps_all[5] if not np.isnan(aps_all[5]) else -1.0

    # --- AR at each maxDet cap (area=all) -----------------------------------
    ars = []
    for cap in max_dets:
        recalls = []
        evals = [
            match_image(det_boxes[i], det_scores[i], gt_boxes[i], max_det=cap)
            for i in range(n_images)
        ]
        num_gt = sum(e.num_gt for e in evals)
        if num_gt == 0:
            ars.append(-1.0)
            continue
        for ti in range(len(IOU_THRESHOLDS)):
            tp = sum(int(e.matched[ti].sum()) for e in evals)
            recalls.append(tp / num_gt)
        ars.append(float(np.mean(recalls)))

    # --- Operating point + curves at IoU 0.5 --------------------------------
    precision_at_f1 = 0.0
    recall_at_f1 = 0.0
    curves: "list[dict]" = []
    if pr_data_all is not None and pr_data_all[0] is not None:
        s, p, r = pr_data_all[0]
        if p.size:
            f1 = 2 * p * r / np.maximum(p + r, 1e-12)
            best = int(np.argmax(f1))
            precision_at_f1 = float(p[best])
            recall_at_f1 = float(r[best])
            if compute_curves:
                # Reference artifact shape: list of {x, y, name} dicts
                # (ref: src/models/vision/yolo.py:281-300).
                env = np.maximum.accumulate(p[::-1])[::-1]
                idx = np.searchsorted(r, RECALL_THRESHOLDS, side="left")
                valid = idx < r.size
                pr_y = np.zeros_like(RECALL_THRESHOLDS)
                pr_y[valid] = env[idx[valid]]
                curves = [
                    {
                        "x": RECALL_THRESHOLDS.tolist(),
                        "y": pr_y.tolist(),
                        "name": "Precision-Recall(B)",
                    },
                    {"x": s.tolist(), "y": f1.tolist(), "name": "F1-Confidence(B)"},
                    {"x": s.tolist(), "y": p.tolist(), "name": "Precision-Confidence(B)"},
                    {"x": s.tolist(), "y": r.tolist(), "name": "Recall-Confidence(B)"},
                ]

    return CocoMetrics(
        map50_95=map50_95,
        map50=map50,
        map75=map75,
        precision=precision_at_f1,
        recall=recall_at_f1,
        ap_small=_mean(ap_by_range["small"]),
        ap_medium=_mean(ap_by_range["medium"]),
        ap_large=_mean(ap_by_range["large"]),
        ar_1=ars[0],
        ar_10=ars[1],
        ar_100=ars[2],
        ap_per_iou=[float(a) for a in aps_all],
        curves=curves,
    )
