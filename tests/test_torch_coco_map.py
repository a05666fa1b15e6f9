"""The port's copy of ``ops/coco_map.py`` against the JAX package's (CPU).

Both are numpy; the copy must return exactly the same values: the full
metrics dict (curves included) on every case of
``tests/fixtures/coco_map_golden.json`` and on seeded random problems of
``tests/cocoeval_oracle.py`` (ties, duplicates, empty images, area-range
boundaries), and the same per-image matching, P/R curves and interpolated
AP. Equality is exact (NaN equal to NaN).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import cocoeval_oracle
from multimodal_moe_torch.ops import coco_map as tmap
from multimodal_moe_tpu.ops import coco_map as jmap

FIXTURE = Path(__file__).parent / "fixtures" / "coco_map_golden.json"


def assert_same(a, b, path="metrics"):
    """Exact equality of nested dicts, lists, arrays and numbers."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        assert a == b or (a != a and b != b), (path, a, b)


def _both(det_boxes, det_scores, gt_boxes, **kw):
    return (tmap.evaluate_detections(det_boxes, det_scores, gt_boxes, **kw).to_metrics_dict(),
            jmap.evaluate_detections(det_boxes, det_scores, gt_boxes, **kw).to_metrics_dict())


def test_constants_are_the_same():
    np.testing.assert_array_equal(tmap.IOU_THRESHOLDS, jmap.IOU_THRESHOLDS)
    np.testing.assert_array_equal(tmap.RECALL_THRESHOLDS, jmap.RECALL_THRESHOLDS)
    assert tmap.AREA_RANGES == jmap.AREA_RANGES


@pytest.mark.parametrize("chunk", range(4))
def test_golden_fixtures(chunk):
    cases = json.loads(FIXTURE.read_text())["cases"][chunk::4]
    assert cases
    for c in cases:
        det_boxes = [np.asarray(b, np.float64).reshape(-1, 4) for b in c["det_boxes"]]
        det_scores = [np.asarray(s, np.float64) for s in c["det_scores"]]
        gt_boxes = [np.asarray(g, np.float64).reshape(-1, 4) for g in c["gt_boxes"]]
        got, ref = _both(det_boxes, det_scores, gt_boxes, compute_curves=True)
        assert_same(got, ref, f"case {c['case']}")


@pytest.mark.parametrize("case", range(12))
def test_random_problems(case):
    rng = np.random.default_rng(91000 + case)
    det_boxes, det_scores, gt_boxes = cocoeval_oracle.random_problem(rng, case)
    for curves in (False, True):
        got, ref = _both(det_boxes, det_scores, gt_boxes, compute_curves=curves)
        assert_same(got, ref)


def test_detector_like_float32_inputs():
    """float32 boxes and scores as the evaluator hands them over, with
    padded-out images (no detection, no ground truth)."""
    rng = np.random.default_rng(7)
    det_boxes, det_scores, gt_boxes = [], [], []
    for i in range(6):
        n, m = (0, 0) if i == 3 else (int(rng.integers(10, 40)), int(rng.integers(1, 8)))
        xy = rng.uniform(0, 1200, (n + m, 2))
        wh = rng.uniform(4, 200, (n + m, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        det_boxes.append(boxes[:n])
        det_scores.append(rng.uniform(0, 1, n).astype(np.float32))
        # jittered copies of some detections, and boxes nothing detects
        found = boxes[:m] + rng.normal(0, 3, (m, 4)).astype(np.float32)
        gt_boxes.append(np.concatenate([found, boxes[n:]])[: m + 2])
    got, ref = _both(det_boxes, det_scores, gt_boxes, compute_curves=True)
    assert 0.0 < got["map50"] < 1.0
    assert_same(got, ref)


@pytest.mark.parametrize("area", list(jmap.AREA_RANGES))
def test_match_image_and_curves(area):
    rng = np.random.default_rng(len(area))
    det, gt = rng.uniform(0, 300, (30, 4)), rng.uniform(0, 300, (9, 4))
    det[:, 2:] += det[:, :2]
    gt[:, 2:] += gt[:, :2]
    scores = np.round(rng.uniform(0, 1, 30), 1)  # ties
    kw = dict(area_range=jmap.AREA_RANGES[area], max_det=20)
    a, b = tmap.match_image(det, scores, gt, **kw), jmap.match_image(det, scores, gt, **kw)
    for field in ("scores", "matched", "ignored", "num_gt"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(tmap._np_pairwise_iou(det, gt), jmap._np_pairwise_iou(det, gt))
    curve_t = tmap._precision_recall_curve(a.scores, a.matched[0], a.ignored[0], a.num_gt)
    curve_j = jmap._precision_recall_curve(b.scores, b.matched[0], b.ignored[0], b.num_gt)
    for x, y in zip(curve_t, curve_j):
        np.testing.assert_array_equal(x, y)
    assert tmap._interpolated_ap(*curve_t[1:]) == jmap._interpolated_ap(*curve_j[1:])
