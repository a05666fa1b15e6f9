"""The port's ``train/evaluator.py`` against the JAX package's (CPU).

* The tail alone: the same fixed ``(boxes, scores)`` handed to both
  ``evaluate_detector``s (NMS and the DETR top-k, with and without curves,
  a padded row, ``gt_from_batch`` off) give the same metrics, exactly,
  apart from the ``speed_*`` keys.
* End to end, YOLO-n at 64×128 (Flax weights converted), two batches of
  B=3 with one padded row and ground truth planted from JAX's own
  detections; the same for a YUV420 batch, a tiny MoE-YOLO-n with
  ``solar_bin`` and a tiny RT-DETR (``use_nms=False``). The metrics agree
  within 1e-6. Scores are discrete choices' keys (NMS order, the ranking
  of the PR curve), so first: the per-anchor scores agree within
  ``SCORE_TOL`` (the YOLO logit tolerance of tests/test_torch_yolo.py, 1e-4,
  times the sigmoid's largest slope 1/4), and no kept score lies within ``SCORE_TOL`` of a rival (a
  candidate it overlaps at the IoU threshold, another kept detection, or
  the score threshold). Random-init scores crowd near sigmoid(-4.6), so the
  class head's kernel is scaled by 10 (RT-DETR's final one, its bias
  centring the logits) and the score threshold is 0.3, which spreads them
  and leaves ~12 YOLO candidates an image.
* ``make_inference_step``'s top-k pool against JAX's ``topk_candidates``.
* ``model_flops_g`` against JAX's: FlopCounterMode counts only the
  convolutions, each output 2·k·k·C_in operations whether its window lies
  on zero padding or not; XLA's cost analysis leaves the padded products
  out and adds the elementwise work. On YOLO-n the port's count is 1.156×
  XLA's at 64×128 (the borders are a large share of the small maps), 1.031×
  at 256×512 and 1.007× at 704×1248; the test holds 64×128 to 1.0-1.2.
* ``make_ema_val_fn`` in a two-epoch CPU ``DetectionTrainer.fit``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RTDETR_PIXEL_TOL, detection_batches, load_flax, numpy_variables,
                           randomize_norm, rtdetr_numpy_variables)
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector as TorchMoE
from multimodal_moe_torch.models.rtdetr import RTDETRDetector as TorchRTDETR
from multimodal_moe_torch.models.yolo import YoloDetector as TorchYolo
from multimodal_moe_torch.ops import nms_kernel
from multimodal_moe_torch.ops.preprocess import yuv420_to_rgb_u8
from multimodal_moe_torch.train import evaluator as tev
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_tpu.models.moe_yolo import MoEYoloDetector as JaxMoE
from multimodal_moe_tpu.models.rtdetr import RTDETRDetector as JaxRTDETR
from multimodal_moe_tpu.models.yolo import YoloDetector as JaxYolo
from multimodal_moe_tpu.ops.boxes import pairwise_iou as jax_iou
from multimodal_moe_tpu.ops.nms import batched_nms as jax_nms
from multimodal_moe_tpu.train import evaluator as jev
from test_torch_moe_yolo import _spread_routers

H, W, B = 64, 128, 3
SCORE_TOL = 2.5e-5     # logits within 1e-4 (test_torch_yolo.py); sigmoid' <= 1/4
METRIC_TOL = 1e-6
SCORE_THR = 0.3        # with the class head scaled by CLS_SCALE: ~12 candidates an image
CLS_SCALE = 10.0
RT_CFG = dict(hidden_dim=64, num_queries=20, num_decoder_layers=2, num_heads=4,
              backbone_depths=(1, 1, 1, 1))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _no_speed(metrics):
    assert {"speed_preprocess_ms_per_img", "speed_inference_ms_per_img",
            "speed_postprocess_ms_per_img"} <= set(metrics)
    return {k: v for k, v in metrics.items() if not k.startswith("speed_")}


def _assert_metrics(got, ref, tol=0.0):
    """Equal metrics, or within ``tol``; the curves' confidence axes (the
    scores themselves) within SCORE_TOL then."""
    got, ref = _no_speed(got), _no_speed(ref)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "curves_results" and tol:
            for g, r in zip(got[k], v, strict=True):
                assert g["name"] == r["name"] and len(g["x"]) == len(r["x"])
                x_tol = 0.0 if r["name"] == "Precision-Recall(B)" else SCORE_TOL
                np.testing.assert_allclose(g["x"], r["x"], rtol=0, atol=x_tol)
                np.testing.assert_allclose(g["y"], r["y"], rtol=0, atol=tol)
        elif isinstance(v, (dict, list)):
            assert got[k] == v, k
        elif tol == 0.0:
            assert got[k] == v and type(got[k]) is type(v), (k, got[k], v)
        else:
            assert abs(got[k] - v) <= tol, (k, got[k], v)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3), dtype=np.uint8)


def _batch(images, gt_boxes, gt_mask, valid, **extra):
    return {"image": images, "gt_boxes": gt_boxes, "gt_mask": gt_mask,
            "batch_valid": np.asarray(valid, bool), **extra}


# --------------------------------------------------------------------------
# the tail alone
# --------------------------------------------------------------------------

def _fixed_outputs(seed, n=200):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (B, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (B, n, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, n)).astype(np.float32)
    gt = np.concatenate([boxes[:, :4] + rng.normal(0, 1.5, (B, 4, 4)),
                         rng.uniform(0, 100, (B, 1, 4)).cumsum(-1)], 1).astype(np.float32)
    mask = np.ones((B, 5), bool)
    mask[:, -1] = False
    return boxes, scores, gt, mask


@pytest.mark.parametrize("use_nms,curves,gt_from_batch", [
    (True, True, True), (True, False, True), (False, True, True), (True, False, False)])
def test_tail_alone_gives_the_same_metrics(use_nms, curves, gt_from_batch):
    outputs = [_fixed_outputs(seed) for seed in (1, 2)]
    batches = [_batch(_images(B, 0), gt, mask, [True, True, i == 0])
               for i, (_, _, gt, mask) in enumerate(outputs)]
    kw = dict(use_nms=use_nms, compute_curves=curves, gt_from_batch=gt_from_batch,
              iou_threshold=0.5, max_det=100)
    fed = iter(outputs)
    ref = jev.evaluate_detector(iter(batches), lambda images: tuple(
        jnp.asarray(a) for a in next(fed)[:2]), **kw)
    fed = iter(outputs)
    got = tev.evaluate_detector(iter(batches), lambda images: tuple(
        torch.from_numpy(a) for a in next(fed)[:2]), device="cpu", **kw)
    assert got["n_images"] == ref["n_images"] == 5
    if gt_from_batch:
        assert 0.0 < ref["map50"] < 1.0
    else:
        assert "map50" not in got
    _assert_metrics(got, ref)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.evaluate_detector([], lambda images: None)


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

class Pair:
    """One detector in both frameworks, with the JAX steps built once (each
    ``make_inference_step`` is a jit of its own): ``jstep`` at SCORE_THR,
    as evaluated, and ``janchor`` per anchor (no top-k decode)."""

    def __init__(self, jmodel, variables, tmodel, ctx=None):
        self.jmodel, self.variables, self.tmodel, self.ctx = jmodel, variables, tmodel, ctx
        self.jstep = jev.make_inference_step(jmodel, score_threshold=SCORE_THR)
        self.janchor = (jev.make_inference_step(jmodel, topk_decode=False)
                        if hasattr(tmodel, "head") else self.jstep)
        self.params = dict(tmodel.state_dict())

    def jax_eval(self, batches, **kw):
        return jev.evaluate_detector(iter(batches), lambda images, ctx=None: self.jstep(
            self.variables, images, ctx), score_threshold=SCORE_THR, **kw)

    def port_eval(self, batches, **kw):
        step = tev.make_inference_step(self.tmodel, score_threshold=SCORE_THR)
        return tev.evaluate_detector(iter(batches), lambda images, ctx=None: step(
            self.params, images, ctx), score_threshold=SCORE_THR, device="cpu", **kw)

    def anchor_outputs(self, images, ctx=None):
        """Per-anchor (or per-query) boxes and scores of both, in anchor order."""
        tstep = tev.make_inference_step(self.tmodel, topk_decode=False)
        jb, js = jax.device_get(self.janchor(self.variables, jnp.asarray(images),
                                             None if ctx is None else jnp.asarray(ctx)))
        tb, ts = tstep(self.params, images, None if ctx is None else torch.from_numpy(ctx))
        return np.asarray(jb), np.asarray(js), tb.numpy(), ts.numpy()


def _scaled_yolo_heads(variables):
    for i in range(3):
        pred = variables["params"]["head"][f"cls{i}_pred"]
        pred["kernel"] = pred["kernel"] * CLS_SCALE
    return variables


@pytest.fixture(scope="module")
def yolo():
    jmodel = JaxYolo(num_classes=1, variant="n")
    variables = jax.device_get(jax.jit(
        lambda r: jmodel.init(r, jnp.zeros((1, H, W, 3)), train=False))(jax.random.PRNGKey(0)))
    variables = _scaled_yolo_heads(randomize_norm(variables, seed=2))
    return Pair(jmodel, variables, load_flax(TorchYolo(num_classes=1, variant="n"), variables))


def _assert_well_defined(batches, outputs, box_tol, use_nms=True):
    """Per-anchor scores within SCORE_TOL and boxes within ``box_tol``; no
    kept score within SCORE_TOL of a rival (see the module docstring)."""
    kept_all = []
    for batch, (jb, js, tb, ts) in zip(batches, outputs):
        np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=box_tol)
        assert np.abs(js - SCORE_THR).min() > SCORE_TOL
        # all kept detections (no NMS for the DETR family: IoU <= 1 < 2)
        res = jax.device_get(jax_nms(jnp.asarray(jb), jnp.asarray(js), max_det=js.shape[1],
                                     score_threshold=SCORE_THR,
                                     iou_threshold=0.7 if use_nms else 2.0))
        for i in np.nonzero(batch["batch_valid"])[0]:
            kept_boxes, kept_scores = res.boxes[i][res.valid[i]], res.scores[i][res.valid[i]]
            kept_all.append(kept_scores)
            if not use_nms:
                continue
            iou = np.asarray(jax_iou(jnp.asarray(kept_boxes), jnp.asarray(jb[i])))
            itself = (js[i][None] == kept_scores[:, None]) & (
                jb[i][None] == kept_boxes[:, None]).all(-1)
            rival = (js[i][None] > SCORE_THR) & (iou >= 0.7) & ~itself
            assert (itself.sum(1) == 1).all()
            gaps = np.abs(js[i][None] - kept_scores[:, None])[rival]
            assert gaps.size == 0 or gaps.min() > SCORE_TOL, gaps.min()
    ranked = np.sort(np.concatenate(kept_all))
    assert ranked.size >= 5 and np.diff(ranked).min() > SCORE_TOL


def _planted_batches(pair, images_list, valid_list, seed, **extra):
    """Batches whose ground truth is JAX's own kept boxes 0 and 2 of each
    image (the top-scoring queries 0 and 3 without NMS), jittered by ~1.5
    px, plus one box nothing detects, and one padded slot."""
    rng = np.random.default_rng(seed)
    use_nms = hasattr(pair.tmodel, "head")
    batches = []
    for n, (images, valid) in enumerate(zip(images_list, valid_list)):
        ctx = {k: v[n] for k, v in extra.items()}
        boxes, scores = pair.jstep(pair.variables, jnp.asarray(images),
                                   *[jnp.asarray(v) for v in ctx.values()])
        res = jax.device_get(jax_nms(boxes, scores, score_threshold=SCORE_THR,
                                     iou_threshold=0.7 if use_nms else 2.0))
        gt = np.zeros((len(images), 4, 4), np.float32)
        mask = np.zeros((len(images), 4), bool)
        for i in range(len(images)):
            kept = res.boxes[i][res.valid[i]][[0, 2] if use_nms else [0, 3]]
            gt[i, :2] = kept + rng.normal(0, 1.5, kept.shape)
            gt[i, 2] = [5.0, 5.0, 25.0, 17.0]
            mask[i, :3] = True
        batches.append(_batch(images, gt, mask, valid, **ctx))
    return batches


def test_yolo_end_to_end(yolo):
    images = [_images(B, 3), _images(B, 4)]
    batches = _planted_batches(yolo, images, [[True] * 3, [True, True, False]], 5)
    _assert_well_defined(batches, [yolo.anchor_outputs(b["image"]) for b in batches],
                         box_tol=5e-3)
    before = nms_kernel.nms_keep_launches
    got = yolo.port_eval(batches, compute_curves=True)
    ref = yolo.jax_eval(batches, compute_curves=True)
    assert nms_kernel.nms_keep_launches == before  # the CPU takes the plain version
    assert got["n_images"] == 5 and 0.0 < ref["map50"] < 1.0
    _assert_metrics(got, ref, METRIC_TOL)


def test_yolo_yuv_batch(yolo):
    """A YUV420 batch: both convert it on their device, then score it."""
    rng = np.random.default_rng(6)
    y = rng.integers(0, 256, (B, H, W), dtype=np.uint8)
    cb = rng.integers(0, 256, (B, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (B, H // 2, W // 2), dtype=np.uint8)
    rgb = yuv420_to_rgb_u8(*(torch.from_numpy(p) for p in (y, cb, cr))).numpy()
    (batch,) = _planted_batches(yolo, [rgb], [[True, False, True]], 7)
    _assert_well_defined([batch], [yolo.anchor_outputs(rgb)], box_tol=5e-3)
    yuv = {k: v for k, v in batch.items() if k != "image"}
    yuv.update(y=y, cb=cb, cr=cr)
    got = yolo.port_eval([yuv])
    ref = yolo.jax_eval([yuv])
    assert got["n_images"] == 2 and 0.0 < ref["map50"] < 1.0
    _assert_metrics(got, ref, METRIC_TOL)
    # the same as the RGB batch
    _assert_metrics(yolo.port_eval([batch]), got)


@pytest.mark.parametrize("k", [16, 64])
def test_inference_step_pool_matches_topk_candidates(yolo, k):
    """The top-k candidate pool of both steps (selection well defined: the
    k-th and (k+1)-th scores are further apart than SCORE_TOL)."""
    images = _images(B, 8)
    _, js, _, _ = yolo.anchor_outputs(images)
    top = -np.sort(-js, axis=-1)
    assert (top[:, k - 1] - top[:, k]).min() > SCORE_TOL
    jb, jsc = jax.device_get(jev.make_inference_step(yolo.jmodel, num_candidates=k)(
        yolo.variables, jnp.asarray(images)))
    tb, tsc = tev.make_inference_step(yolo.tmodel, num_candidates=k)(yolo.params, images)
    assert tuple(tb.shape) == (B, k, 4) and tuple(tsc.shape) == (B, k)
    np.testing.assert_allclose(tsc.numpy(), jsc, rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=5e-3)


def test_moe_yolo_end_to_end_with_solar_bins():
    jmodel = JaxMoE(num_classes=1, variant="n")
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), seed=9)
    variables = _scaled_yolo_heads(_spread_routers(variables, seed=10))
    pair = Pair(jmodel, variables, load_flax(TorchMoE(num_classes=1, variant="n"), variables))
    solar = np.array([[1, 4, 0]], np.int32)
    batches = _planted_batches(pair, [_images(B, 11)], [[True, True, False]], 12,
                               solar_bin=solar)
    _assert_well_defined(batches, [pair.anchor_outputs(batches[0]["image"], solar[0])],
                         box_tol=5e-3)
    got = pair.port_eval(batches)
    ref = pair.jax_eval(batches)
    assert got["n_images"] == 2 and 0.0 < ref["map50"] < 1.0
    _assert_metrics(got, ref, METRIC_TOL)
    # the bins reach the router: other bins, other scores
    step = tev.make_inference_step(pair.tmodel)
    images = batches[0]["image"]
    assert not torch.equal(step(pair.params, images, torch.tensor([5, 2, 3]))[1],
                           step(pair.params, images, torch.from_numpy(solar[0]))[1])


def test_rtdetr_end_to_end_without_nms():
    jmodel = JaxRTDETR(num_classes=1, **RT_CFG)
    variables = rtdetr_numpy_variables(jmodel, H, W, seed=3)
    images = _images(B, 13)
    # the final class head scaled, and its bias centring the logits on these images
    last = variables["params"][f"cls_head{RT_CFG['num_decoder_layers'] - 1}"]
    last["kernel"] = last["kernel"] * CLS_SCALE
    tmodel = load_flax(TorchRTDETR(num_classes=1, **RT_CFG), variables)
    _, logits = tev.make_inference_step(tmodel, use_sigmoid=False)(
        dict(tmodel.state_dict()), images)
    last["bias"] = last["bias"] - float(logits.median())
    pair = Pair(jmodel, variables, load_flax(TorchRTDETR(num_classes=1, **RT_CFG), variables))
    (batch,) = _planted_batches(pair, [images], [[True, False, True]], 14)
    _assert_well_defined([batch], [pair.anchor_outputs(images)], box_tol=RTDETR_PIXEL_TOL,
                         use_nms=False)
    got = pair.port_eval([batch], use_nms=False)
    ref = pair.jax_eval([batch], use_nms=False)
    assert got["n_images"] == 2 and 0.0 < ref["map50"] < 1.0
    _assert_metrics(got, ref, METRIC_TOL)


def test_model_flops_against_xla(yolo):
    ref = jev.model_flops_g(yolo.jmodel, yolo.variables, H, W)
    got = tev.model_flops_g(yolo.tmodel, H, W)
    assert ref and got
    assert 1.0 <= got / ref <= 1.2, (got, ref)
    assert tev.model_flops_g(yolo.tmodel, -1, W) is None  # best effort: never raises


def test_ema_val_fn_in_a_two_epoch_fit(tmp_path):
    template = TorchYolo(num_classes=1, variant="n", generator=torch.Generator().manual_seed(0))
    train = detection_batches(2, H, W, b=2, seed=15)
    val = detection_batches(1, H, W, b=2, seed=16)
    cfg = DetTrainConfig(variant="n", img_h=H, img_w=W, epochs=2, batch=2)
    trainer = DetectionTrainer(template, cfg, steps_per_epoch=len(train), device="cpu")
    seen = []

    def make_loader():
        seen.append(len(seen))
        return iter(copy.deepcopy(val))

    val_fn = tev.make_ema_val_fn(template, make_loader)
    state, summary = trainer.fit(train, run_dir=tmp_path, val_fn=val_fn)
    assert len(seen) == 2 and len(summary["history"]) == 2
    for row in summary["history"]:
        assert {"val_map50", "val_map50_95", "val_n_images"} <= set(row)
        assert row["val_n_images"] == 2
    # the EMA parameters with the trained model's running statistics
    direct = tev.evaluate_detector(iter(val), tev.make_inference_fn(
        template, {**dict(state.model.named_buffers()), **state.ema_params}),
        compute_curves=False, device="cpu")
    assert direct["map50"] == summary["history"][-1]["val_map50"]
    assert template.training and state.model.training  # modes restored
