"""The YOLO loss (``losses/tal.py``) and CIoU (``ops/boxes.py``) of the port
against the JAX package on the CPU, float32, on seeded problems at the
anchors of a 64×128 frame (A = 168).

Tolerances and why:
* ``elementwise_ciou`` 1e-6 and its gradient 1e-5 of its max (arctan,
  divisions; the two frameworks round the same expression in other ways).
* ``_dfl_loss`` 1e-6 and its gradient 1e-6, targets at the clip edge
  ``REG_MAX − 1 − 0.01`` included.
* ``assign_targets``: ``fg_mask`` and the target boxes exact (discrete
  choices and gathers; each problem first checks that no GT's 10th and
  11th align metrics are closer than 1e-4 relative, so the top-k is the
  same in both); target scores within 1e-6 (``score^0.5 · IoU^6`` and its
  normalisation, a few float32 roundings).
* ``yolo_loss``: the loss and its parts within 1e-5 relative, ``num_fg``
  exact, the gradients for ``cls_logits`` and ``box_logits`` within 1e-5 of
  their norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_moe_torch.losses import tal as tt
from multimodal_moe_torch.models import yolo as ty
from multimodal_moe_torch.ops import boxes as tb
from multimodal_moe_tpu.losses import tal as jt
from multimodal_moe_tpu.models import yolo as jy
from multimodal_moe_tpu.ops import boxes as jb

H, W = 64, 128
PTS, STRIDES = ty.make_anchors(H, W)
A = PTS.shape[0]


def _boxes(rng, n, lo=4.0, hi=40.0):
    xy = rng.uniform(0, [W - hi, H - hi], (*n, 2))
    wh = rng.uniform(lo, hi, (*n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_elementwise_ciou_and_gradient():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (300,)), _boxes(rng, (300,))
    a[:5] = b[:5]                        # identical boxes
    a[5:10, 2:] = a[5:10, :2] + 1e-3     # near-degenerate widths
    ref, ref_g = jax.value_and_grad(lambda x: jb.elementwise_ciou(x, jnp.asarray(b)).sum())(
        jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_()
    got = tb.elementwise_ciou(x, torch.from_numpy(b))
    got.sum().backward()
    ref_each = np.asarray(jb.elementwise_ciou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.detach().numpy(), ref_each, rtol=0, atol=1e-6)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=0, atol=1e-5 * np.abs(ref_g).max())
    assert float(got[:5].min()) > 1 - 1e-6


def test_dfl_loss_and_gradient():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2.0, (50, 4, ty.REG_MAX)).astype(np.float32)
    target = rng.uniform(-1.0, ty.REG_MAX + 1.0, (50, 4)).astype(np.float32)
    target[:8] = ty.REG_MAX - 1 - 0.01    # the clip edge
    target[8:12] = 0.0
    fn = lambda lg: jt._dfl_loss(lg, jnp.asarray(target))  # noqa: E731
    ref = np.asarray(fn(jnp.asarray(logits)))
    ref_g = np.asarray(jax.grad(lambda lg: fn(lg).sum())(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = tt._dfl_loss(x, torch.from_numpy(target))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=0, atol=1e-6)


def test_sigmoid_bce_matches():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 8.0, (1000,)).astype(np.float32)
    targets = rng.uniform(0, 1, (1000,)).astype(np.float32)
    ref = np.asarray(jt.optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(targets)))
    got = tt.optax_sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# assign_targets
# --------------------------------------------------------------------------

def _problem(kind: str, seed: int):
    """B=2, M=4 ground-truth slots; predictions around the anchors."""
    rng = np.random.default_rng(seed)
    b, m = 2, 4
    gt = _boxes(rng, (b, m), lo=12.0, hi=40.0)
    mask = np.ones((b, m), bool)
    labels = rng.integers(0, 2, (b, m)).astype(np.int32)
    # predicted boxes: each anchor's own box of 1-5 strides a side
    half = rng.uniform(1.0, 5.0, (b, A, 2)) * STRIDES[None]
    pred = np.concatenate([PTS[None] - half, PTS[None] + half], -1).astype(np.float32)
    scores = 1 / (1 + np.exp(-rng.normal(0, 1.5, (b, A, 2))))
    if kind == "cold_start":
        scores = np.full((b, A, 2), 1 / (1 + np.exp(4.6)))       # the class prior bias
        half = rng.uniform(0.4, 0.6, (b, A, 2)) * np.ones_like(STRIDES[None])  # ~1 px boxes
        pred = np.concatenate([PTS[None] - half, PTS[None] + half], -1).astype(np.float32)
    elif kind == "overlapping":
        gt[:, 1] = gt[:, 0] + np.array([2.0, 1.0, 3.0, 2.0], np.float32)  # claim the same anchors
        labels[:, 1] = labels[:, 0]
    elif kind == "masked_rows":
        mask[0, 2:] = False
        mask[1, 1] = False
        gt[~mask] = 0.0
    elif kind == "no_anchor_inside":
        gt[0, 0] = [1.0, 1.0, 3.5, 3.0]    # between anchor centres: no anchor inside
    return (scores.astype(np.float32), pred, labels, gt, mask)


def _assert_topk_defined(metric: np.ndarray):
    """Every GT's 10th and 11th align metrics are further apart than the
    frameworks' rounding (both select the same candidates)."""
    srt = -np.sort(-metric, axis=-1)
    kth, nxt = srt[..., tt.TOPK - 1], srt[..., tt.TOPK]
    gap = (kth - nxt) / np.maximum(kth, 1e-38)
    assert ((kth <= 0) | (gap > 1e-4)).all(), float(gap[kth > 0].min())


KINDS = ["random", "cold_start", "overlapping", "masked_rows", "no_anchor_inside"]


@pytest.mark.parametrize("kind", KINDS)
def test_assign_targets_matches(kind):
    scores, pred, labels, gt, mask = _problem(kind, seed=KINDS.index(kind))
    args = (scores, pred, PTS, labels, gt, mask)
    ref = jax.device_get(jt.assign_targets(*map(jnp.asarray, args)))
    got = tt.assign_targets(*(torch.from_numpy(a) for a in args))

    # the align metric the top-k ranks, as both compute it
    ious = np.clip(np.asarray(jb.pairwise_iou(jnp.asarray(gt), jnp.asarray(pred))), 0, 1)
    cls = np.take_along_axis(scores.transpose(0, 2, 1), labels[:, :, None], 1)
    lt = PTS[None, None] - gt[:, :, None, :2]
    rb = gt[:, :, None, 2:] - PTS[None, None]
    inside = (np.minimum(lt.min(-1), rb.min(-1)) > tt.EPS) & mask[:, :, None]
    metric = np.where(inside, cls ** 0.5 * ious ** 6, 0.0)
    _assert_topk_defined(metric)

    np.testing.assert_array_equal(got.fg_mask.numpy(), ref.fg_mask)
    np.testing.assert_array_equal(got.target_boxes.numpy(), ref.target_boxes)
    np.testing.assert_allclose(got.target_scores.numpy(), ref.target_scores, rtol=0, atol=1e-6)
    assert got.fg_mask.any()
    if kind == "cold_start":   # the > 0 invariant: metrics ~1e-12 still assign
        assert 0 < metric[metric > 0].max() < 1e-6
    if kind == "overlapping":  # some anchor was claimed by both GTs
        top = np.argsort(-metric, axis=-1, kind="stable")[..., : tt.TOPK]
        both = [np.intersect1d(top[i, 0], top[i, 1]).size for i in range(2)]
        assert max(both) > 0
    if kind == "masked_rows":  # padded GT rows own no anchor
        assigned = got.target_boxes.numpy()[got.fg_mask.numpy()]
        assert not (assigned == 0).all(-1).any()
    if kind == "no_anchor_inside":
        assert not inside[0, 0].any()
        hit = (got.target_boxes.numpy()[0] == gt[0, 0]).all(-1) & got.fg_mask.numpy()[0]
        assert not hit.any()


# --------------------------------------------------------------------------
# yolo_loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "cold_start", "masked_rows"])
def test_yolo_loss_and_gradients_match(kind):
    rng = np.random.default_rng(10 + KINDS.index(kind))
    _, _, labels, gt, mask = _problem(kind, seed=KINDS.index(kind))
    labels = np.zeros_like(labels)
    b = gt.shape[0]
    prior = -4.6 if kind == "cold_start" else 0.0
    cls_logits = (prior + rng.normal(0, 1.0, (b, A, 1))).astype(np.float32)
    box_logits = rng.normal(0, 1.0, (b, A, 4 * ty.REG_MAX)).astype(np.float32)

    def jax_loss(cl, bl):
        out = {"cls_logits": cl, "box_logits": bl,
               "boxes": jy.decode_boxes(bl, jnp.asarray(PTS), jnp.asarray(STRIDES)),
               "anchor_points": jnp.asarray(PTS), "anchor_strides": jnp.asarray(STRIDES)}
        return jt.yolo_loss(out, jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask))

    (_, ref_m), ref_g = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls_logits), jnp.asarray(box_logits))
    ref_m, ref_g = jax.device_get((ref_m, ref_g))

    cl = torch.from_numpy(cls_logits).requires_grad_()
    bl = torch.from_numpy(box_logits).requires_grad_()
    pts, strides = torch.from_numpy(PTS), torch.from_numpy(STRIDES)
    out = {"cls_logits": cl, "box_logits": bl, "boxes": ty.decode_boxes(bl, pts, strides),
           "anchor_points": pts, "anchor_strides": strides}
    total, metrics = tt.yolo_loss(out, torch.from_numpy(labels), torch.from_numpy(gt),
                                  torch.from_numpy(mask))
    total.backward()
    assert set(metrics) == set(ref_m) == {"loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"}
    assert int(metrics["num_fg"]) == int(ref_m["num_fg"]) > 0
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_m[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
    for name, t, r in (("cls_logits", cl, ref_g[0]), ("box_logits", bl, ref_g[1])):
        r = np.asarray(r)
        err = float(np.linalg.norm(t.grad.numpy() - r)) / float(np.linalg.norm(r))
        assert err <= 1e-5, (name, err)
