"""PyTorch port of models/moe_yolo.py against the Flax detector (CPU, fp32).

Variant n in each dispatch mode (``dense``, which ``auto`` resolves to at
this size, ``sweep``, ``sparse``, and the fused sparse route) and variant s
(widths 128/256/512) in ``sweep`` and on the fused route, at 64×128 with a
context bin per image. Flax weights, made with numpy at the Flax
parameters' shapes (``numpy_variables``: no init compile; the class prior
bias −4.6 and the experts at the scale of Flax's ``lecun_normal``, whose
fan-in counts the expert axis), are converted; BatchNorms and routers are
randomised so that the check means something (well-separated router
probabilities, context bins that move them). Torch runs two intra-op
threads (pytest workers run side by side). Tolerances are those of
tests/test_torch_yolo.py: logits rtol/atol 1e-4, boxes atol 5e-3 px;
``moe_aux_loss`` within 1e-5 and ``expert_load`` within 1e-6. Routing is
discrete, so before comparing
per-token outputs each level checks that every token's k-th and (k+1)-th
router probabilities are further apart than twice the largest router logit
difference seen. The JAX fused route runs its Pallas kernel in interpret
mode (patched in the test; the JAX package is unchanged).

The serving step with ``context_ids`` against JAX's: ``valid`` and
``classes`` exact, scores atol 1e-6, boxes atol 5e-3 px.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax, numpy_variables
from multimodal_moe_torch import serving as tserving
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.models import moe_yolo as tmy
from multimodal_moe_tpu import serving as jserving
from multimodal_moe_tpu.models import moe as jm
from multimodal_moe_tpu.models import moe_yolo as jmy
from multimodal_moe_tpu.ops import moe_kernels as jk

H, W, K = 64, 128, 2
LEVELS = 3
# mode → (dispatch, fused)
MODES = {"dense": ("dense", False), "sweep": ("sweep", False),
         "sparse": ("sparse", False), "fused": ("sparse", True)}
CASES = [("n", m) for m in MODES] + [("s", "sweep"), ("s", "fused")]
IMAGES = np.random.default_rng(31).uniform(0.0, 1.0, (2, H, W, 3)).astype(np.float32)
CONTEXT = np.array([1, 4], np.int32)


def _spread_routers(variables, seed):
    rng = np.random.default_rng(seed)
    for i in range(LEVELS):
        r = variables["params"][f"moe_level{i}"]["router"]
        d, e = r["router_kernel"].shape
        r["router_kernel"] = rng.normal(0, 2.0 / np.sqrt(d), (d, e)).astype(np.float32)
        r["context_bias"] = rng.normal(0, 1.0, r["context_bias"].shape).astype(np.float32)
    return variables


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _numpy_weights(variant, seed):
    m = jmy.MoEYoloDetector(variant=variant, dispatch="dense")
    v = numpy_variables(m, jnp.zeros((1, H, W, 3)), train=False, seed=seed)
    p = v["params"]
    rng = np.random.default_rng(seed + 100)
    for i in range(LEVELS):
        p["head"][f"cls{i}_pred"]["bias"][:] = -4.6
        lvl = p[f"moe_level{i}"]
        e, d, h = lvl["experts_w1"].shape
        lvl["experts_w1"] = rng.normal(0, (e * d) ** -0.5, (e, d, h)).astype(np.float32)
        lvl["experts_w2"] = rng.normal(0, (e * h) ** -0.5, (e, h, d)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def flax_weights():
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _spread_routers(_numpy_weights(variant, seed=7), seed=8)
        return cache[variant]

    return get


def _jax_forward(variant, variables, mode):
    """JAX outputs and each level's router logits."""
    dispatch, fused = MODES[mode]
    with pytest.MonkeyPatch.context() as mp:
        if fused:  # MoEFFN's own field, and the Pallas kernel in interpret mode
            real = jk.fused_expert_ffn
            mp.setattr(jk, "fused_expert_ffn", lambda *a: real(*a, True))
            mp.setattr(jmy, "MoEFFN", functools.partial(jm.MoEFFN, use_pallas_ffn=True))
        model = jmy.MoEYoloDetector(variant=variant, dispatch=dispatch)
        out, state = jax.jit(lambda v, x, c: model.apply(
            v, x, train=False, context_ids=c, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "router",
        ))(variables, jnp.asarray(IMAGES), jnp.asarray(CONTEXT))
    inter = state["intermediates"]
    logits = [inter[f"moe_level{i}"]["router"]["__call__"][0] for i in range(LEVELS)]
    return jax.device_get((out, logits))


def _port_model(variant, variables, mode):
    dispatch, fused = MODES[mode]
    model = load_flax(tmy.MoEYoloDetector(variant=variant, dispatch=dispatch), variables)
    for i in range(LEVELS):
        getattr(model, f"moe_level{i}").use_fused_ffn = fused
    return model


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def pair(request, flax_weights):
    variant, mode = request.param
    variables = flax_weights(variant)
    ref, ref_logits = _jax_forward(variant, variables, mode)
    model = _port_model(variant, variables, mode)
    logits = []
    hooks = [getattr(model, f"moe_level{i}").router.register_forward_hook(
        lambda m, a, o: logits.append(o.numpy())) for i in range(LEVELS)]
    with torch.inference_mode():
        out = model(torch.from_numpy(IMAGES), context_ids=torch.from_numpy(CONTEXT))
    for h in hooks:
        h.remove()
    got = {k: v.numpy() for k, v in out.items()}
    return ref, got, ref_logits, logits


def test_routing_is_well_defined(pair):
    _, _, ref_logits, logits = pair
    for i, (r, g) in enumerate(zip(ref_logits, logits)):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32
        diff = float(np.abs(g - r).max())
        assert diff < 1e-4, (i, diff)
        probs = -np.sort(-np.asarray(jax.nn.softmax(jnp.asarray(r), -1)), axis=-1)
        gap = probs[:, K - 1] - probs[:, K]
        assert gap.min() > 2 * diff, (i, float(gap.min()), diff)


def test_outputs_match(pair):
    ref, got, _, _ = pair
    assert set(got) == set(ref) == {"box_logits", "cls_logits", "boxes", "anchor_points",
                                    "anchor_strides", "moe_aux_loss", "expert_load"}
    for k in ref:
        assert got[k].shape == np.asarray(ref[k]).shape and got[k].dtype == np.float32, k
    assert np.abs(ref["box_logits"]).max() > 0.1
    for k in ("box_logits", "cls_logits"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=5e-3)
    np.testing.assert_array_equal(got["anchor_points"], ref["anchor_points"])


def test_moe_aux_loss_and_expert_load_match(pair):
    ref, got, _, _ = pair
    np.testing.assert_allclose(got["moe_aux_loss"], ref["moe_aux_loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["expert_load"], ref["expert_load"], rtol=1e-6, atol=0)
    assert got["expert_load"].shape == (LEVELS, 4)
    np.testing.assert_allclose(got["expert_load"].sum(-1), K, rtol=1e-6)


def test_context_changes_routing(flax_weights):
    model = _port_model("n", flax_weights("n"), "sweep")
    x = torch.from_numpy(IMAGES[:1])
    with torch.inference_mode():
        loads = [model(x, context_ids=torch.tensor([c]))["expert_load"] for c in range(6)]
        default = model(x)["expert_load"]
    assert torch.equal(default, loads[5])  # no context: the "missing" bin
    assert any(not torch.equal(loads[0], ld) for ld in loads[1:])


def test_router_stays_fp32_in_bf16_model():
    model = tmy.MoEYoloDetector(variant="n", dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).eval()
    model.to(torch.bfloat16)  # a second cast keeps the gates fp32 as well
    for i in range(LEVELS):
        moe = getattr(model, f"moe_level{i}")
        assert moe.router.router_kernel.dtype == moe.router.context_bias.dtype == torch.float32
        assert moe.experts_w1.dtype == moe.experts_b2.dtype == torch.bfloat16
    assert model.head.cls0_pred.weight.dtype == torch.bfloat16
    logits = []
    hook = model.moe_level0.router.register_forward_hook(lambda m, a, o: logits.append(o))
    x = torch.rand(2, H, W, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = model(x, context_ids=torch.tensor([0, 3]))
    hook.remove()
    assert logits[0].dtype == torch.float32
    assert out["boxes"].dtype == torch.float32 and torch.isfinite(out["boxes"]).all()
    assert out["expert_load"].shape == (LEVELS, 4)


def test_state_dict_round_trip(flax_weights):
    variables = flax_weights("n")
    sd = flax_to_state_dict(variables)
    model = tmy.MoEYoloDetector(variant="n")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for i in range(LEVELS):
        p = variables["params"][f"moe_level{i}"]
        moe = getattr(model, f"moe_level{i}")
        # router_kernel is a raw (d, E) parameter: never transposed
        assert torch.equal(moe.router.router_kernel,
                           torch.from_numpy(np.array(p["router"]["router_kernel"])))
        for name in ("experts_w1", "experts_b1", "experts_w2", "experts_b2"):
            assert torch.equal(getattr(moe, name), torch.from_numpy(np.array(p[name])))
    bad = copy.deepcopy(variables)
    bad["params"]["moe_level0"]["experts_w3"] = np.zeros((4, 2, 2), np.float32)
    with pytest.raises(ValueError, match="unsupported parameter"):
        flax_to_state_dict(bad)


NMS_KW = dict(pool=32, iou_threshold=0.7, score_threshold=0.001, max_det=20)
SCORE_TOL = 1e-6


def test_serving_step_with_context_matches_jax(flax_weights):
    variables = flax_weights("n")
    images_u8 = np.random.default_rng(32).integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    ctx = np.array([0, 2, 5], np.int32)
    jmodel = jmy.MoEYoloDetector(variant="n")
    ref = jax.device_get(jserving.make_serving_step(jmodel, **NMS_KW)(
        variables, jnp.asarray(images_u8), jnp.asarray(ctx)))
    ref_out = jax.device_get(jax.jit(lambda v, x, c: jmodel.apply(
        v, x.astype(jnp.float32) / 255.0, train=False, context_ids=c))(
        variables, jnp.asarray(images_u8), jnp.asarray(ctx)))
    model = load_flax(tmy.MoEYoloDetector(variant="n"), variables)
    with torch.inference_mode():
        out = model(torch.from_numpy(images_u8).float() / 255.0, context_ids=torch.from_numpy(ctx))
    # The top pool+1 scores are further apart than twice the frameworks' difference.
    scores = torch.sigmoid(out["cls_logits"][..., 0]).numpy()
    ref_scores = np.asarray(jax.nn.sigmoid(ref_out["cls_logits"][..., 0]))
    diff = float(np.abs(scores - ref_scores).max())
    assert diff <= SCORE_TOL
    top = -np.sort(-ref_scores, axis=-1)[:, : NMS_KW["pool"] + 1]
    assert (-np.diff(top, axis=-1)).min() > 2 * diff, diff

    step = tserving.make_serving_step(model, **NMS_KW)
    got = step(images_u8, ctx)
    assert got.boxes.shape == (3, NMS_KW["max_det"], 4) and bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.classes.numpy(), ref.classes)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores, rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes, rtol=0, atol=5e-3)
    # The context ids reach the model: the "missing" bin for all gives other scores.
    assert not torch.equal(step(images_u8).scores, got.scores)
