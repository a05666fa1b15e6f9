"""MoE-YOLO-n training on ``dispatch="gmm"`` (the grouped GEMM, forward
and backward) and on ``"sweep"``, the port against the JAX trainer on the
CPU: two ``DetectionTrainer.train_step``s with ``moe_yolo_loss``, as set
out in tests/_torch_yolo_train.py. At this size ``auto`` would resolve to
``dense``, so the modes are named. JAX's ``gmm`` mode takes its CPU path
(``moe_apply_gmm(interpret=True)``); the port's, ``gmm_plain`` and
``tgmm_plain`` under the autograd function.

The tolerances and their reasons are those of tests/test_torch_yolo_train.py
(``moe_aux_loss`` is one more metric within 1e-5 relative). Each level's
top-2 expert choice is JAX's; the port's own choice equals it (checked).
Torch runs two intra-op threads (pytest workers run side by side).
"""

import numpy as np
import pytest
import torch

import _torch_yolo_train as ytrain
from multimodal_moe_torch.models import moe_yolo as tmy
from multimodal_moe_tpu.models import moe_yolo as jmy
from test_torch_yolo_train import (
    assert_batch_stats_match,
    assert_losses_match,
    assert_own_assignment_matches,
    assert_params_match,
)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["gmm", "sweep"])
def run(request):
    mode = request.param
    out = ytrain.run_pair(jmy.MoEYoloDetector(variant="n", dispatch=mode),
                          tmy.MoEYoloDetector(variant="n", dispatch=mode),
                          (jmy.moe_yolo_loss, tmy.moe_yolo_loss), seed=12)
    out["mode"] = mode
    return out


def test_moe_yolo_losses_match_jax(run):
    assert all("moe_aux_loss" in m for m in run["metrics"])
    assert_losses_match(run)


def test_moe_yolo_assignment_and_routing_match_jax(run):
    assert_own_assignment_matches(run)
    routes = list(run["rec"]["route"])
    assert len(routes) == len(run["own"]["route"]) == 3 * ytrain.STEPS
    for own in run["own"]["route"]:
        j = next(j for j, r in enumerate(routes) if r.shape[0] == own.shape[0])
        np.testing.assert_array_equal(np.sort(own.numpy(), -1), np.sort(routes.pop(j), -1))


def test_moe_yolo_params_match_jax(run):
    assert_params_match(run)
    moe = [k for k in run["state"].params if k.startswith("moe_level") and "experts_w" in k]
    assert len(moe) == 6


def test_moe_yolo_batch_stats_match_jax(run):
    assert_batch_stats_match(run)
