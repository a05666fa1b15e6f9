"""PyTorch port of models/yolo.py against the Flax detector (fp32, CPU).

Variants n and s at full channel width, both backbone layouts, on a
64×128 input, with numpy weights at the Flax parameters' shapes
(``numpy_variables``: no init compile; the class prior bias −4.6 as Flax
initialises it). Torch runs two intra-op threads (pytest workers run side
by side). Tolerances: logits rtol/atol 1e-4; boxes atol 5e-3 px (the
DFL expectation spreads over 16 bins and is scaled by strides up to 32 px,
so a logit difference of 1e-5 moves a box side by up to ~16·32·1e-5 px);
anchors exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax, numpy_variables
from multimodal_moe_torch.models import yolo as ty
from multimodal_moe_tpu.models import yolo as jy

H, W = 64, 128


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def prior_weights(jmodel, seed: int):
    """``numpy_variables`` with Flax's class prior bias (−4.6)."""
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), train=False, seed=seed)
    for i in range(3):
        variables["params"]["head"][f"cls{i}_pred"]["bias"][:] = -4.6
    return variables


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).uniform(0.0, 1.0, (2, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[("n", "tpu"), ("n", "csp"), ("s", "tpu"), ("s", "csp")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request, images):
    variant, arch = request.param
    jmodel = jy.YoloDetector(num_classes=1, variant=variant, arch=arch)
    variables = prior_weights(jmodel, seed=5)
    ref = jax.device_get(
        jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(images))
    )
    tmodel = load_flax(ty.YoloDetector(num_classes=1, variant=variant, arch=arch), variables)
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in tmodel(torch.from_numpy(images)).items()}
    return ref, got


def test_output_keys_and_shapes(pair):
    ref, got = pair
    assert set(got) == set(ref) == {
        "box_logits", "cls_logits", "boxes", "anchor_points", "anchor_strides"
    }
    for k in ref:
        assert got[k].shape == np.asarray(ref[k]).shape, k
        assert got[k].dtype == np.float32, k


def test_logits_match(pair):
    ref, got = pair
    # Signal, not a faded random net: the check below is meaningful.
    assert np.abs(ref["box_logits"]).max() > 0.1
    for k in ("box_logits", "cls_logits"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_boxes_and_anchors_match(pair):
    ref, got = pair
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got["anchor_points"], ref["anchor_points"])
    np.testing.assert_array_equal(got["anchor_strides"], ref["anchor_strides"])


@pytest.mark.parametrize("variant", ["n", "s", "m", "l"])
def test_scaled_widths_and_depths(variant):
    assert ty.scaled_channels(variant) == jy.scaled_channels(variant)
    assert ty.scaled_depths(variant) == jy.scaled_depths(variant)


@pytest.mark.parametrize("hw", [(64, 128), (704, 1248)])
def test_make_anchors(hw):
    for a, b in zip(ty.make_anchors(*hw), jy.make_anchors(*hw)):
        np.testing.assert_array_equal(a, b)


def test_dfl_decode_matches():
    rng = np.random.default_rng(11)
    logits = rng.normal(0.0, 3.0, (2, 168, 4 * ty.REG_MAX)).astype(np.float32)
    pts, strides = jy.make_anchors(H, W)
    ref_d = np.asarray(jy.dfl_expectation(jnp.asarray(logits)))
    got_d = ty.dfl_expectation(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-6, atol=1e-6)
    ref_b = np.asarray(jy.decode_boxes(jnp.asarray(logits), jnp.asarray(pts), jnp.asarray(strides)))
    got_b = ty.decode_boxes(
        torch.from_numpy(logits), torch.from_numpy(pts), torch.from_numpy(strides)
    ).numpy()
    np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-4)


def test_class_prior_bias_and_strict_names():
    model = ty.YoloDetector(num_classes=1, variant="n", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.all(sd["head.cls0_pred.bias"] == -4.6)
    assert torch.all(sd["head.box2_pred.bias"] == 0.0)
    assert "backbone.SpaceToDepthStem_0.ConvBNAct_0.conv.weight" in sd
    assert "neck.PlainStage_0.ConvBNAct_1.bn.running_mean" in sd


def test_seeded_init_is_reproducible():
    a = ty.YoloDetector(variant="n", generator=torch.Generator().manual_seed(7)).state_dict()
    b = ty.YoloDetector(variant="n", generator=torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_forward_runs():
    model = ty.YoloDetector(variant="n", dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, H, W, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = model(x)
    assert out["box_logits"].dtype == torch.float32
    assert out["boxes"].shape == (1, 168, 4)
    assert torch.isfinite(out["boxes"]).all()
