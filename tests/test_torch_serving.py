"""PyTorch port of serving.py against the JAX serving step (CPU).

Same YOLO-n weights (Flax init, BatchNorms randomised, converted), pool
K=32 and max_det=20 as tests/test_serving.py uses. Three checks:

(a) the forward outputs agree within the detector tolerances;
(b) the port's full NMS tail applied to JAX's own forward outputs gives
    JAX's ``NmsResult`` exactly: random-init scores sit close together, so a
    difference of 1e-6 in the forward could reorder a top-K, and this
    separates the tail from the forward;
(c) the port's full and topk tails agree bitwise.

The DETR route: the same serving step over the tiny RT-DETR of
tests/test_torch_rtdetr.py (Flax weights converted), against JAX's serving
step on the same uint8 images: ``valid`` and ``classes`` exact, scores
atol 1e-6 (the logits agree within ~1e-5 and the scores sit near
sigmoid(-4.6), where the slope is ~0.01), pixel boxes atol 1e-2 (the
detector tolerance of ``_torch_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import RTDETR_PIXEL_TOL, load_flax, randomize_norm, rtdetr_pair
from multimodal_moe_torch import serving as tserving
from multimodal_moe_torch.entry import entry
from multimodal_moe_torch.models.yolo import YoloDetector as TorchYolo
from multimodal_moe_tpu import serving as jserving
from multimodal_moe_tpu.models.yolo import YoloDetector as JaxYolo

H, W, K, MAX_DET = 64, 128, 32, 20
NMS_KW = dict(pool=K, iou_threshold=0.7, score_threshold=0.001, max_det=MAX_DET)


@pytest.fixture(scope="module")
def setup():
    images_u8 = np.random.default_rng(21).integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    jmodel = JaxYolo(num_classes=1, variant="n")
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, H, W, 3)), train=False))(
        jax.random.PRNGKey(0)
    )
    variables = randomize_norm(variables, seed=2)
    jax_out = jax.device_get(jax.jit(
        lambda v, x: jmodel.apply(v, x.astype(jnp.float32) / 255.0, train=False)
    )(variables, jnp.asarray(images_u8)))
    jax_res = jax.device_get(
        jserving.make_serving_step(jmodel, **NMS_KW)(variables, jnp.asarray(images_u8))
    )
    tmodel = load_flax(TorchYolo(num_classes=1, variant="n"), variables)
    return images_u8, jax_out, jax_res, tmodel


def _as_torch(out):
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_forward_matches(setup):
    images_u8, jax_out, _, tmodel = setup
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(images_u8).float() / 255.0)
    for k in ("box_logits", "cls_logits"):
        np.testing.assert_allclose(got[k].numpy(), jax_out[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), jax_out["boxes"], rtol=0, atol=5e-3)


@pytest.mark.parametrize("tail", ["full", "topk"])
def test_tail_on_jax_outputs(setup, tail):
    _, jax_out, jax_res, _ = setup
    out = _as_torch(jax_out)
    kw = dict(iou_threshold=0.7, score_threshold=0.001, max_det=MAX_DET)
    if tail == "topk":
        got = tserving.yolo_serving_nms(out, k=K, **kw)
    else:
        scores = torch.sigmoid(out["cls_logits"][..., 0])
        got = tserving.batched_nms(out["boxes"], scores, num_candidates=K, **kw)
    assert bool(got.valid.any())
    if tail == "full":
        _equal(got, jax_res)
    else:
        # The topk tail decodes the K candidates itself: selection exact,
        # boxes within the decode's float32 summation-order tolerance.
        for name in ("valid", "classes", "scores"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(jax_res, name))
        np.testing.assert_allclose(got.boxes.numpy(), jax_res.boxes, rtol=0, atol=1e-4)


def test_full_and_topk_tails_bitwise(setup):
    images_u8, _, _, tmodel = setup
    full = tserving.make_serving_step(tmodel, tail="full", **NMS_KW)(images_u8)
    topk = tserving.make_serving_step(tmodel, tail="topk", **NMS_KW)(images_u8)
    assert full.boxes.shape == (3, MAX_DET, 4) and full.valid.dtype == torch.bool
    _equal(full, topk)


def test_serving_step_matches_jax_result_shape_and_validity(setup):
    images_u8, _, jax_res, tmodel = setup
    got = tserving.make_serving_step(tmodel, **NMS_KW)(torch.from_numpy(images_u8))
    for x, y in zip(got, jax_res):
        assert tuple(x.shape) == np.asarray(y).shape
    np.testing.assert_array_equal(got.valid.sum(1).numpy(), np.asarray(jax_res.valid).sum(1))


def test_topk_candidates_match_jax(setup):
    _, jax_out, _, _ = setup
    ref_b, ref_s = jax.device_get(jserving.topk_candidates(jax_out, k=K))
    got_b, got_s = tserving.topk_candidates(_as_torch(jax_out), k=K)
    np.testing.assert_array_equal(got_s.numpy(), ref_s)
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        bad = _as_torch(jax_out)
        bad["cls_logits"] = torch.cat([bad["cls_logits"]] * 2, dim=-1)
        tserving.topk_candidates(bad, k=K)


def test_detr_topk_select_matches_jax():
    rng = np.random.default_rng(22)
    boxes = rng.uniform(0, 100, (2, 50, 4)).astype(np.float32)
    scores = (rng.integers(0, 8, (2, 50)) / 8.0).astype(np.float32)  # ties
    ref = jax.device_get(jserving.detr_topk_select(jnp.asarray(boxes), jnp.asarray(scores),
                                                   max_det=30, score_threshold=0.2))
    got = tserving.detr_topk_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    max_det=30, score_threshold=0.2)
    _equal(got, ref)


def test_bad_tail_rejected(setup):
    with pytest.raises(ValueError):
        tserving.make_serving_step(setup[3], tail="fast")


def test_entry_on_cpu_shapes():
    fn, (images,) = entry(device="cpu")
    assert images.shape == (1, 704, 1248, 3) and images.dtype == torch.uint8
    boxes, scores = fn(images)
    a = 88 * 156 + 44 * 78 + 22 * 39
    assert boxes.shape == (1, a, 4) and scores.shape == (1, a)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


# --------------------------------------------------------------------------
# DETR route: RT-DETR through the same serving step
# --------------------------------------------------------------------------

RT_CFG = dict(hidden_dim=64, num_queries=20, num_decoder_layers=2, num_heads=4)
RT_SCORE_TOL = 1e-6


@pytest.fixture(scope="module")
def rtdetr():
    images_u8 = np.random.default_rng(23).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    pair = rtdetr_pair(RT_CFG, 3, images_u8.astype(np.float32) / 255.0)
    return images_u8, pair


@pytest.mark.parametrize("max_det", [20, 8])
def test_rtdetr_serving_step_matches_jax(rtdetr, max_det):
    images_u8, pair = rtdetr
    kw = dict(max_det=max_det, score_threshold=0.001)
    ref = jax.device_get(
        jserving.make_serving_step(pair.jmodel, **kw)(pair.variables, jnp.asarray(images_u8)))
    # The order of the top max_det is well defined at this tolerance.
    scores = 1.0 / (1.0 + np.exp(-np.asarray(pair.jax_out["cls_logits"][..., 0], np.float64)))
    top = -np.sort(-scores, axis=-1)[:, : max_det + 1]
    assert (-np.diff(top, axis=-1)).min() > 2 * RT_SCORE_TOL
    got = tserving.make_serving_step(pair.tmodel, **kw)(images_u8)
    assert got.boxes.shape == (2, max_det, 4) and got.valid.dtype == torch.bool
    assert bool(got.valid.all())  # random weights: every score ≈ sigmoid(-4.6) > 0.001
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.classes.numpy(), ref.classes)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0, atol=RT_SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes, rtol=0, atol=RTDETR_PIXEL_TOL)


def test_rtdetr_serving_threshold_masks_like_jax(rtdetr):
    """A threshold between the scores: the entries below it come out as
    boxes 0, score 0, class -1 in both."""
    images_u8, pair = rtdetr
    scores = 1.0 / (1.0 + np.exp(-np.asarray(pair.jax_out["cls_logits"][..., 0], np.float64)))
    srt = np.sort(scores.ravel())
    mid = len(srt) // 2
    assert srt[mid] - srt[mid - 1] > 2 * RT_SCORE_TOL
    kw = dict(max_det=20, score_threshold=float(srt[mid - 1] + srt[mid]) / 2)
    ref = jax.device_get(
        jserving.make_serving_step(pair.jmodel, **kw)(pair.variables, jnp.asarray(images_u8)))
    got = tserving.make_serving_step(pair.tmodel, **kw)(images_u8)
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.classes.numpy(), ref.classes)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0, atol=RT_SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes, rtol=0, atol=RTDETR_PIXEL_TOL)
