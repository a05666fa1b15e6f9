"""YOLO-n training, the port against the JAX trainer on the CPU: two
``DetectionTrainer.train_step``s with ``yolo_loss`` (the default loss of
both trainers), as set out in tests/_torch_yolo_train.py.

Tolerances (float32) and why. Train-mode BatchNorm normalises with Flax's
fast variance ``E[x²] − E[x]²``, whose float32 cancellation makes JAX the
less exact side (tests/test_torch_rtdetr_train.py: JAX's trunk gradient is
off by 5.5e-3 of its norm against float64, the port's by 2.8e-6). So:
* the losses and their parts within 1e-5 relative (seen: 1.8e-6),
  ``num_fg`` exact (the assignment is JAX's; the port's own equals it,
  checked separately, target scores within 1e-5);
* the parameters after step 2 moved by lr·(momentum-carried gradients):
  each tensor's difference from JAX within 2e-2 of its own update's norm
  plus 1e-7 (seen: 6.5e-3, a small BatchNorm bias update), and over all
  tensors within 5e-4 of the total update (seen: 7e-5);
* the running statistics atol 2e-5 (two momentum steps of batch
  statistics; seen: 3.5e-6).
"""

import numpy as np
import pytest
import torch

import _torch_yolo_train as ytrain
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.losses import tal as tt
from multimodal_moe_torch.models import yolo as ty
from multimodal_moe_tpu.losses import tal as jt
from multimodal_moe_tpu.models import yolo as jy


@pytest.fixture(scope="module")
def run():
    return ytrain.run_pair(jy.YoloDetector(num_classes=1, variant="n"),
                           ty.YoloDetector(num_classes=1, variant="n"),
                           (jt.yolo_loss, tt.yolo_loss), seed=11)


def assert_losses_match(run):
    for got, ref in zip(run["metrics"], run["jax_metrics"]):
        assert int(got["num_fg"]) == int(ref["num_fg"]) > 0
        for k, v in ref.items():
            if k != "num_fg":
                np.testing.assert_allclose(got[k], float(v), rtol=1e-5, atol=0, err_msg=k)


def assert_own_assignment_matches(run):
    for own, ref in zip(run["own"]["assign"], run["rec"]["assign"]):
        np.testing.assert_array_equal(own.fg_mask.numpy(), ref[2])
        np.testing.assert_array_equal(own.target_boxes.numpy(), ref[0])
        np.testing.assert_allclose(own.target_scores.numpy(), ref[1], rtol=0, atol=1e-5)


def assert_params_match(run):
    state, jstate = run["state"], run["jstate"]
    assert state.step == int(jstate.step) == ytrain.STEPS
    before = flax_to_state_dict({"params": run["variables"]["params"]})
    ref = flax_to_state_dict({"params": jstate.params})
    got = state.params
    assert set(ref) == set(got)
    diff_sq = upd_sq = 0.0
    for k, v in ref.items():
        upd = float((v - before[k]).double().norm())
        diff = float((got[k].detach() - v).double().norm())
        assert diff <= 2e-2 * upd + 1e-7, (k, diff, upd)
        diff_sq, upd_sq = diff_sq + diff ** 2, upd_sq + upd ** 2
    assert diff_sq ** 0.5 <= 5e-4 * upd_sq ** 0.5, (diff_sq ** 0.5, upd_sq ** 0.5)
    moved = [k for k in before if not torch.equal(got[k].detach(), before[k])]
    assert len(moved) > 0.9 * len(before)


def assert_batch_stats_match(run):
    ref = flax_to_state_dict({"batch_stats": run["jstate"].batch_stats})
    got = run["state"].batch_stats
    assert len(got) > 50 and set(got) <= set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_yolo_losses_match_jax(run):
    assert_losses_match(run)


def test_yolo_assignment_matches_jax(run):
    assert_own_assignment_matches(run)


def test_yolo_params_match_jax(run):
    assert_params_match(run)


def test_yolo_batch_stats_match_jax(run):
    assert_batch_stats_match(run)


def test_forward_train_flag_must_match_mode():
    model = ty.YoloDetector(variant="n", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.zeros(1, 64, 128, 3)
    with pytest.raises(ValueError, match="model.train"):
        model(x, train=True)
    with pytest.raises(TypeError, match="bool"):
        model(x, torch.tensor([1]))
    out = model.train()(x, train=True)
    assert out["box_logits"].shape == (1, 168, 64)
