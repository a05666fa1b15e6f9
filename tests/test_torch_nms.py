"""PyTorch port of ops/nms.py and ops/nms_kernel.py against the JAX NMS.

On the CPU the port runs its plain versions (the scan mirror and the keep
mask sweep); they are held to the JAX scan (``batched_nms``) and to the
Pallas kernel in interpret mode. ``valid`` and ``classes`` must be equal,
boxes and scores within rtol 1e-6 (they are gathered, not computed, so
they are in fact equal). The edge-box cases (touching, disjoint,
identical, degenerate, huge, NaN and ±inf boxes, pairs at IoU exactly 0.7;
thresholds 0 and 1) hold the port to JAX's IoU, its scan and the Pallas
kernel where the float inputs are not ordinary. The CUDA kernel test (12 cases: pools off a
multiple of 64, B=1, the evaluator's pool at B=128, identical, disjoint and
non-finite boxes, pairs at IoU exactly 0.7, thresholds 0 and 1) holds the
kernel bitwise to the plain versions and skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NMS_KINDS, nms_boxes, require_cuda
from multimodal_moe_torch.ops import boxes as tboxes
from multimodal_moe_torch.ops import nms_kernel
from multimodal_moe_torch.ops.nms import NEG_INF, _batched_nms_plain, _preselect, batched_nms
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


# Every kind of _torch_parity.nms_boxes but the plain random one.
EDGE_KINDS = [kind for kind in NMS_KINDS if kind != "random"]
EDGE_THRESHOLDS = [0.0, 0.7, 1.0]


def _edge_batch(kind, b=2, n=160, seed=16, num_classes=3):
    rng = np.random.default_rng(seed)
    boxes = np.stack([nms_boxes(kind, n, seed=seed + i) for i in range(b)])
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

    def test_pool_above_the_shared_memory_walk(self):
        """K = 2048, a pool the card takes since the kernel has no limit on K
        (ROADMAP C1): JAX's scan and the port agree on it."""
        boxes, scores, classes = _random_batch(b=2, n=2048 + 64, seed=17, ties=True,
                                               num_classes=3)
        got, ref = _both(boxes, scores, classes, iou_threshold=0.7, max_det=300,
                         num_candidates=2048)
        assert int(got.valid.sum()) > 300
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

    @pytest.mark.parametrize("t", EDGE_THRESHOLDS)
    @pytest.mark.parametrize("kind", EDGE_KINDS)
    def test_edge_boxes_class_aware(self, kind, t):
        boxes, scores, classes = _edge_batch(kind)
        got, ref = _both(boxes, scores, classes, iou_threshold=t, score_threshold=0.05,
                         max_det=100, num_candidates=128)
        _assert_same(got, ref)


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

    @pytest.mark.parametrize("t", EDGE_THRESHOLDS)
    @pytest.mark.parametrize("kind", EDGE_KINDS)
    def test_keep_mask_matches_pallas_kernel_at_edge_boxes(self, kind, t):
        boxes, scores, _ = _edge_batch(kind, n=96)
        valid = (scores > 0.1).astype(np.int32)
        ref = nms_keep_mask_pallas(jnp.asarray(boxes.transpose(0, 2, 1)), jnp.asarray(valid),
                                   iou_threshold=t, interpret=True)
        got = nms_kernel.nms_keep_mask(
            torch.from_numpy(boxes), torch.from_numpy(valid),
            torch.zeros(valid.shape, dtype=torch.int32),
            iou_threshold=t, class_agnostic=True,
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


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_pairwise_iou_bitwise_at_edge_boxes(kind):
    """Equal bits where the IoU is a number; NaN at the same pairs (a NaN's
    payload is not part of the contract: both sides only compare it)."""
    boxes, _, _ = _edge_batch(kind, n=96)
    ref = np.asarray(jboxes.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = tboxes.pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    number = ~np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), ~number)
    np.testing.assert_array_equal(got[number].view(np.int32), ref[number].view(np.int32))


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


def _bitwise_equal(x, y) -> bool:
    """Equal bits: NaN boxes gathered from the same input compare equal."""
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


# (b, k, class_agnostic, kind, iou_threshold): "ties" is _random_batch's
# forced score ties and repeated boxes with an all-invalid image; the other
# kinds are _torch_parity.nms_boxes'.
CARD_CASES = [
    (128, 512, True, "ties", 0.7),
    (16, 1024, False, "ties", 0.7),
    (4, 300, False, "ties", 0.7),
    (4, 1000, False, "ties", 0.7),
    (1, 512, True, "random", 0.7),
    (128, 1024, False, "ties", 0.7),
    (8, 512, True, "identical", 0.7),
    (8, 512, True, "disjoint", 0.7),
    (8, 512, False, "at_threshold", 0.7),
    (8, 512, False, "non_finite", 0.7),
    (8, 512, False, "ties", 0.0),
    (8, 512, True, "ties", 1.0),
    # Above the shared-memory walk's K = 1024: the kernel's other launches.
    (16, 1025, False, "ties", 0.7),
    (16, 2048, False, "ties", 0.7),
    (16, 4096, False, "ties", 0.7),
    (2, 18018, False, "ties", 0.7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,agnostic,kind,t", CARD_CASES)
def test_cuda_kernel_matches_plain(b, k, agnostic, kind, t):
    dev = require_cuda()
    boxes, scores, classes = _random_batch(b=b, n=k + 64, seed=15, ties=True, num_classes=3)
    if kind != "ties":
        boxes = np.stack([nms_boxes(kind, k + 64, seed=15 + i) for i in range(b)])
    if b > 1:
        scores[0] = 0.0  # one all-invalid image
    t_ = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    kw = dict(iou_threshold=t, score_threshold=0.001, max_det=300,
              num_candidates=k, class_agnostic=agnostic)
    before = nms_kernel.nms_keep_launches
    got = batched_nms(t_(boxes), t_(scores), t_(classes), **kw)
    torch.cuda.synchronize()
    assert nms_kernel.nms_keep_launches == before + 1
    ref = _batched_nms_plain(t_(boxes), t_(scores), t_(classes), **kw)
    for x, y in zip(got, ref):
        assert _bitwise_equal(x, y)
    if b > 1:
        assert not got.valid[0].any()
    # The keep mask itself, on the same preselected candidates.
    top_boxes, top_scores, top_classes = _preselect(
        t_(boxes), t_(scores), t_(classes), score_threshold=0.001, num_candidates=k)
    args = (top_boxes.contiguous(), (top_scores > NEG_INF / 2).to(torch.int32),
            top_classes.contiguous())
    keep = nms_kernel.nms_keep_mask(*args, iou_threshold=t, class_agnostic=agnostic)
    plain = nms_kernel._nms_keep_mask_plain(*args, iou_threshold=t, class_agnostic=agnostic)
    assert torch.equal(keep, plain)


@pytest.mark.cuda
def test_cuda_kernel_scratch_past_2gb():
    """B = 128 at K = 18,018 needs 2.6 GB of scratch, so the last images'
    masks lie past 2**31 bytes: their keep masks equal the kernel's and the
    plain version's on those images alone."""
    dev = require_cuda()
    b, k = 128, 18018
    boxes, scores, classes = _random_batch(b=b, n=k, seed=18, ties=True, num_classes=3)
    t_ = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    top_boxes, top_scores, top_classes = _preselect(
        t_(boxes), t_(scores), t_(classes), score_threshold=0.001, num_candidates=k)
    args = (top_boxes.contiguous(), (top_scores > NEG_INF / 2).to(torch.int32),
            top_classes.contiguous())
    kw = dict(iou_threshold=0.7, class_agnostic=False)
    keep = nms_kernel.nms_keep_mask(*args, **kw)
    assert b * nms_kernel._lib().nms_scratch_words(k) * 4 > 2**31
    for i in (b - 1, b - 2):
        one = tuple(a[i:i + 1].contiguous() for a in args)
        assert torch.equal(keep[i:i + 1], nms_kernel.nms_keep_mask(*one, **kw))
        assert torch.equal(keep[i:i + 1], nms_kernel._nms_keep_mask_plain(*one, **kw))
