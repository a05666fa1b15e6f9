"""The port's DETR loss pieces against JAX on the CPU: GIoU, the batched
assignment, ``hungarian_match`` and ``detr_loss`` (encoder head, auxiliary
and final layers, and denoising layers) on identical predictions.

Tolerances (float32): GIoU atol 1e-6; the assignment exactly equal, on
problems whose optimum is unique by more than the frameworks' cost
difference (``assignment_margin``); the loss and each metric within 1e-5
(rtol and atol); the loss gradients with respect to every ``pred_logits``
and ``pred_boxes`` within 1e-5·max(1, max|JAX gradient|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_moe_torch.losses import hungarian as th
from multimodal_moe_torch.ops.assignment import assignment_margin
from multimodal_moe_torch.ops import assignment as ta
from multimodal_moe_torch.ops import boxes as tb
from multimodal_moe_tpu.losses import hungarian as jh
from multimodal_moe_tpu.ops import assignment as ja
from multimodal_moe_tpu.ops import boxes as jb

B, Q, M, D_SLOTS = 2, 12, 4, 16   # D = 2 groups · 2 (pos/neg) · M
IMG_HW = (64, 96)
GT_MASK = np.array([[True, True, True, False], [True, True, False, False]])


def _boxes_xyxy(rng, shape, scale=1.0):
    ctr = rng.uniform(0.15, 0.85, shape + (2,))
    wh = rng.uniform(0.05, 0.35, shape + (2,))
    return (np.concatenate([ctr - wh / 2, ctr + wh / 2], -1) * scale).astype(np.float32)


def test_giou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes_xyxy(rng, (3, 50)), _boxes_xyxy(rng, (3, 50))
    a[0, :5] = b[0, :5]                        # identical boxes
    a[1, :5] = b[1, :5] + 2.0                  # disjoint boxes
    got = tb.elementwise_giou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.elementwise_giou(a, b)), atol=1e-6, rtol=0)
    got = tb.pairwise_giou(torch.from_numpy(a[:, :7]), torch.from_numpy(b[:, :5])).numpy()
    assert got.shape == (3, 7, 5)
    np.testing.assert_allclose(got, np.asarray(jb.pairwise_giou(a[:, :7], b[:, :5])),
                               atol=1e-6, rtol=0)
    cx = rng.uniform(0, 1, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(tb.cxcywh_to_xyxy(torch.from_numpy(cx)).numpy(),
                                  np.asarray(jb.cxcywh_to_xyxy(cx)))
    np.testing.assert_array_equal(tb.xyxy_to_cxcywh(torch.from_numpy(cx)).numpy(),
                                  np.asarray(jb.xyxy_to_cxcywh(cx)))


def test_batched_assignment_matches_jax():
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 10, (4, 15, 6)).astype(np.float32)
    valid = np.ones((4, 6), bool)
    valid[1, 4:] = False
    valid[2, 0] = valid[2, 3] = False
    valid[3] = False
    for i in range(4):
        assert assignment_margin(cost[i], valid[i]) > 1e-3
    got = ta.batched_lsa_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    ref = np.asarray(ja.batched_lsa_assign(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)
    assert (got[~valid] == 0).all()           # invalid columns get row 0
    all_valid = ta.batched_lsa_assign(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(all_valid,
                                  np.asarray(ja.batched_lsa_assign(jnp.asarray(cost))))


def test_assignment_needs_enough_rows():
    with pytest.raises(ValueError, match="at least as many rows"):
        ta.batched_lsa_assign(torch.zeros((1, 2, 3)))


def _predictions(seed):
    """Encoder, 2 auxiliary and the final layer, 2 denoising layers."""
    rng = np.random.default_rng(seed)

    def layer(q):
        xyxy = _boxes_xyxy(rng, (B, q))
        cxcywh = np.concatenate([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                                 xyxy[..., 2:] - xyxy[..., :2]], -1)
        return (rng.normal(-1.0, 1.5, (B, q, 1)).astype(np.float32), cxcywh.astype(np.float32))

    return [layer(Q) for _ in range(4)], [layer(D_SLOTS) for _ in range(2)]


def _ground_truth(seed):
    rng = np.random.default_rng(seed)
    gt = _boxes_xyxy(rng, (B, M), scale=np.array([IMG_HW[1], IMG_HW[0]] * 2, np.float32))
    labels = np.zeros((B, M), np.int32)
    return labels, np.where(GT_MASK[..., None], gt, 0.0).astype(np.float32), GT_MASK


DN_IS_POS = np.repeat(np.arange(4) % 2 == 0, M)


def _outputs(layers, dn_layers, lib):
    enc, aux1, aux2, final = [{"pred_logits": lg, "pred_boxes": bx} for lg, bx in layers]
    return {"pred_logits": final["pred_logits"], "pred_boxes": final["pred_boxes"],
            "aux_outputs": [aux1, aux2], "enc_outputs": enc,
            "dn_outputs": [{"pred_logits": lg, "pred_boxes": bx} for lg, bx in dn_layers],
            "dn_is_pos": lib(DN_IS_POS), "dn_groups": 2}


@pytest.fixture(scope="module")
def problem():
    layers, dn_layers = _predictions(2)
    labels, gt, mask = _ground_truth(3)

    def jax_loss(layers, dn_layers):
        out = _outputs(layers, dn_layers, jnp.asarray)
        return jh.detr_loss(out, jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask),
                            img_hw=IMG_HW)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        layers, dn_layers)
    return dict(layers=layers, dn_layers=dn_layers, labels=labels, gt=gt, mask=mask,
                jax_loss=float(loss), jax_metrics=jax.device_get(metrics),
                jax_grads=jax.device_get(grads))


def _recording(record, real):
    def solve(cost, col_valid=None):
        record.append(np.asarray(cost))
        return real(cost, col_valid)
    return solve


def test_hungarian_match_matches_jax(problem, monkeypatch):
    """Equal assignments, on problems whose optimum is unique by more than
    2·M times the largest difference between the two cost matrices."""
    t = torch.from_numpy
    h, w = IMG_HW
    gt_n = problem["gt"] / np.array([w, h, w, h], np.float32)
    gt_cxcywh = np.concatenate([(gt_n[..., :2] + gt_n[..., 2:]) / 2, gt_n[..., 2:] - gt_n[..., :2]],
                               -1).astype(np.float32)
    costs = {"jax": [], "port": []}
    monkeypatch.setattr(ja, "batched_lsa_assign", _recording(costs["jax"], ja.batched_lsa_assign))
    monkeypatch.setattr(th, "batched_lsa_assign", _recording(costs["port"], th.batched_lsa_assign))
    mask = problem["mask"]
    for logits, boxes in problem["layers"]:
        ref = np.asarray(jh.hungarian_match(*map(jnp.asarray, (logits, boxes, problem["labels"],
                                                              gt_cxcywh, mask))))
        got = th.hungarian_match(t(logits), t(boxes), t(problem["labels"]), t(gt_cxcywh),
                                 t(mask)).numpy()
        delta = float(np.abs(costs["port"][-1] - costs["jax"][-1]).max())
        for i in range(B):
            assert assignment_margin(costs["jax"][-1][i], mask[i]) > 2 * M * delta
        np.testing.assert_array_equal(got[mask], ref[mask])
        assert (got[~mask] == 0).all()


def _port_loss(problem):
    layers = [tuple(torch.from_numpy(a).requires_grad_() for a in ly) for ly in problem["layers"]]
    dn = [tuple(torch.from_numpy(a).requires_grad_() for a in ly) for ly in problem["dn_layers"]]
    out = _outputs(layers, dn, torch.from_numpy)
    t = torch.from_numpy
    loss, metrics = th.detr_loss(out, t(problem["labels"]), t(problem["gt"]), t(problem["mask"]),
                                 img_hw=IMG_HW)
    return loss, metrics, layers, dn


def test_detr_loss_and_metrics_match_jax(problem):
    loss, metrics, _, _ = _port_loss(problem)
    assert set(metrics) == set(problem["jax_metrics"])
    np.testing.assert_allclose(float(loss.detach()), problem["jax_loss"], rtol=1e-5, atol=1e-5)
    for k, v in problem["jax_metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_detr_loss_gradients_match_jax(problem):
    loss, _, layers, dn = _port_loss(problem)
    loss.backward()
    ref_layers, ref_dn = problem["jax_grads"]
    for tag, got, ref in (("layer", layers, ref_layers), ("dn", dn, ref_dn)):
        for i, (g_pair, r_pair) in enumerate(zip(got, ref)):
            for name, g, r in zip(("pred_logits", "pred_boxes"), g_pair, r_pair):
                r = np.asarray(r)
                scale = max(1.0, float(np.abs(r).max()))
                np.testing.assert_allclose(g.grad.numpy(), r, rtol=0, atol=1e-5 * scale,
                                           err_msg=f"{tag}{i} {name}")
                assert np.abs(r).max() > 0


def test_padded_columns_point_at_row_zero_without_target(problem):
    """Padded GT columns are matched to row 0 with IoU 0: "amax" leaves row
    0's target to a real match, if it has one."""
    loss_all, _, _, _ = _port_loss(problem)
    mask = problem["mask"].copy()
    assert not mask[:, -1].any()
    gt = problem["gt"].copy()
    gt[:, -1] = 123.0                       # garbage in a padded slot changes nothing
    loss, _ = th.detr_loss(_outputs([tuple(map(torch.from_numpy, ly)) for ly in problem["layers"]],
                                    [tuple(map(torch.from_numpy, ly)) for ly in problem["dn_layers"]],
                                    torch.from_numpy),
                           torch.from_numpy(problem["labels"]), torch.from_numpy(gt),
                           torch.from_numpy(mask), img_hw=IMG_HW)
    np.testing.assert_allclose(float(loss), float(loss_all.detach()), rtol=1e-6)
