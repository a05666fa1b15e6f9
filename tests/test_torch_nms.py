"""PyTorch port of ops/nms.py and ops/nms_kernel.py against the JAX NMS.

On the CPU the port runs its plain versions (the scan mirror and the keep
mask sweep); they are held to the JAX scan (``batched_nms``) and to the
Pallas kernel in interpret mode. ``valid`` and ``classes`` must be equal,
boxes and scores within rtol 1e-6 (they are gathered, not computed, so
they are in fact equal). The CUDA kernel test skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import require_cuda
from multimodal_moe_torch.ops import boxes as tboxes
from multimodal_moe_torch.ops import nms_kernel
from multimodal_moe_torch.ops.nms import _batched_nms_plain, batched_nms
from multimodal_moe_tpu.ops import boxes as jboxes
from multimodal_moe_tpu.ops.nms import batched_nms as jax_batched_nms
from multimodal_moe_tpu.ops.nms_pallas import batched_nms_pallas, nms_keep_mask_pallas


def _random_batch(b=3, n=256, seed=0, ties=False, num_classes=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (b, n, 2))
    wh = rng.uniform(5, 120, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if ties:
        # Few distinct scores and repeated boxes: order among equals decides.
        scores = (rng.integers(1, 6, (b, n)) / 6.0).astype(np.float32)
        boxes[:, 1::7] = boxes[:, 0:1]
    else:
        scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    classes = rng.integers(0, num_classes, (b, n)).astype(np.int32)
    return boxes, scores, classes


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6)
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool


def _both(boxes, scores, classes=None, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (
        batched_nms(t(boxes), t(scores), t(classes), **kw),
        jax_batched_nms(j(boxes), j(scores), j(classes), **kw),
    )


class TestAgainstJaxScan:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_single_class(self, seed):
        boxes, scores, _ = _random_batch(seed=seed)
        _assert_same(*_both(boxes, scores, iou_threshold=0.5, score_threshold=0.05,
                            max_det=50, num_candidates=256))

    @pytest.mark.parametrize("agnostic", [False, True])
    def test_three_classes(self, agnostic):
        boxes, scores, classes = _random_batch(seed=4, num_classes=3)
        _assert_same(*_both(boxes, scores, classes, iou_threshold=0.5, max_det=60,
                            num_candidates=128, class_agnostic=agnostic))

    @pytest.mark.parametrize("early_exit", [False, True])
    def test_forced_ties(self, early_exit):
        boxes, scores, classes = _random_batch(seed=5, ties=True, num_classes=2)
        _assert_same(*_both(boxes, scores, classes, iou_threshold=0.3, max_det=80,
                            num_candidates=200, early_exit=early_exit))

    def test_early_exit_sparse_survivors(self):
        boxes = np.asarray([[[0, 0, 10, 10], [100, 100, 110, 110], [1, 1, 11, 11]]],
                           np.float32)
        scores = np.asarray([[0.9, 0.8, 0.85]], np.float32)
        got, ref = _both(boxes, scores, iou_threshold=0.5, max_det=50,
                         num_candidates=3, early_exit=True)
        assert int(got.valid.sum()) == 2
        _assert_same(got, ref)

    def test_all_invalid(self):
        boxes = np.ones((2, 128, 4), np.float32)
        scores = np.zeros((2, 128), np.float32)
        got, ref = _both(boxes, scores, max_det=10, num_candidates=64)
        assert not got.valid.any()
        assert (got.classes == -1).all() and (got.boxes == 0).all() and (got.scores == 0).all()
        _assert_same(got, ref)

    def test_one_image_all_invalid(self):
        boxes, scores, _ = _random_batch(b=3, n=64, seed=6)
        scores[1] = 0.0005  # every score at or below the threshold
        got, ref = _both(boxes, scores, max_det=30, num_candidates=64)
        assert not got.valid[1].any() and got.valid[0].any()
        _assert_same(got, ref)

    def test_fewer_boxes_than_candidates(self):
        boxes, scores, _ = _random_batch(b=2, n=40, seed=7)
        _assert_same(*_both(boxes, scores, max_det=30, num_candidates=1024))

    def test_max_det_above_pool(self):
        boxes, scores, _ = _random_batch(b=2, n=16, seed=8)
        got, ref = _both(boxes, scores, iou_threshold=0.9, max_det=20, num_candidates=8)
        assert got.valid.shape == (2, 20) and not got.valid[:, 8:].any()
        _assert_same(got, ref)

    def test_strict_score_threshold_and_iou_at_threshold(self):
        # IoU([0,0,10,10],[0,0,10,7]) = 0.7 exactly → suppressed at thr 0.7;
        # a score equal to the threshold is not a candidate.
        boxes = np.asarray([[[0, 0, 10, 10], [0, 0, 10, 7], [50, 50, 60, 60]]], np.float32)
        scores = np.asarray([[0.9, 0.8, 0.001]], np.float32)
        got, ref = _both(boxes, scores, iou_threshold=0.7, score_threshold=0.001, max_det=3)
        assert got.valid.tolist() == [[True, False, False]]
        _assert_same(got, ref)

    def test_topk_mode_approx_is_exact(self):
        boxes, scores, _ = _random_batch(b=2, n=300, seed=9)
        t = torch.from_numpy
        a = batched_nms(t(boxes), t(scores), num_candidates=128, topk_mode="approx")
        b = batched_nms(t(boxes), t(scores), num_candidates=128)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        with pytest.raises(ValueError):
            batched_nms(t(boxes), t(scores), topk_mode="fast")


class TestAgainstPallas:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_batched_nms_matches_pallas_interpret(self, seed):
        boxes, scores, _ = _random_batch(seed=seed)
        kw = dict(iou_threshold=0.5, score_threshold=0.05, max_det=50, num_candidates=256)
        ref = batched_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), interpret=True, **kw)
        got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
        _assert_same(got, ref)

    @pytest.mark.parametrize("ties", [False, True])
    def test_keep_mask_matches_pallas_kernel(self, ties):
        boxes, scores, _ = _random_batch(b=3, n=128, seed=10, ties=ties)
        order = np.argsort(-scores, axis=1, kind="stable")
        sb = np.take_along_axis(boxes, order[..., None], axis=1)
        valid = (np.take_along_axis(scores, order, axis=1) > 0.3).astype(np.int32)
        ref = nms_keep_mask_pallas(jnp.asarray(sb.transpose(0, 2, 1)), jnp.asarray(valid),
                                   iou_threshold=0.5, interpret=True)
        got = nms_kernel.nms_keep_mask(
            torch.from_numpy(sb), torch.from_numpy(valid),
            torch.zeros(valid.shape, dtype=torch.int32),
            iou_threshold=0.5, class_agnostic=True,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pairwise_iou_bitwise():
    boxes, _, _ = _random_batch(b=2, n=64, seed=12)
    boxes[0, 3] = [5, 5, 5, 9]  # degenerate: zero area
    ref = np.asarray(jboxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = tboxes.pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, ref)
    ref_e = np.asarray(jboxes.elementwise_iou(jnp.asarray(boxes[0]), jnp.asarray(boxes[1])))
    got_e = tboxes.elementwise_iou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1]))
    np.testing.assert_array_equal(got_e.numpy(), ref_e)


def test_box_conversions_round_trip():
    boxes, _, _ = _random_batch(b=1, n=32, seed=13)
    t = torch.from_numpy(boxes)
    np.testing.assert_allclose(
        tboxes.xyxy_to_cxcywh(t).numpy(), np.asarray(jboxes.xyxy_to_cxcywh(jnp.asarray(boxes))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(tboxes.cxcywh_to_xyxy(tboxes.xyxy_to_cxcywh(t)).numpy(), boxes,
                               rtol=1e-5, atol=1e-4)


def test_keep_mask_wrapper_rejects_bad_input():
    boxes = torch.zeros(2, 8, 4)
    ok = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        nms_kernel.nms_keep_mask(boxes, ok.long(), ok, iou_threshold=0.7, class_agnostic=True)
    with pytest.raises(ValueError):
        nms_kernel.nms_keep_mask(boxes, ok[:, :4], ok, iou_threshold=0.7, class_agnostic=True)
    with pytest.raises(TypeError):
        nms_kernel.nms_keep_mask(boxes.double(), ok, ok, iou_threshold=0.7, class_agnostic=True)


def test_cpu_path_does_not_count_launches():
    before = nms_kernel.nms_keep_launches
    boxes, scores, _ = _random_batch(b=1, n=32, seed=14)
    batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), num_candidates=32)
    assert nms_kernel.nms_keep_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,agnostic", [(128, 512, True), (16, 1024, False)])
def test_cuda_kernel_matches_plain(b, k, agnostic):
    dev = require_cuda()
    boxes, scores, classes = _random_batch(b=b, n=k + 64, seed=15, ties=True, num_classes=3)
    scores[0] = 0.0  # one all-invalid image
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    kw = dict(iou_threshold=0.7, score_threshold=0.001, max_det=300,
              num_candidates=k, class_agnostic=agnostic)
    before = nms_kernel.nms_keep_launches
    got = batched_nms(t(boxes), t(scores), t(classes), **kw)
    torch.cuda.synchronize()
    assert nms_kernel.nms_keep_launches == before + 1
    ref = _batched_nms_plain(t(boxes), t(scores), t(classes), **kw)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert not got.valid[0].any()
