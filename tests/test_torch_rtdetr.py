"""PyTorch port of models/rtdetr.py against the Flax RT-DETR (fp32, CPU).

Each piece on its own (``EncoderLayer``, ``MSDeformAttn``, ``DecoderLayer``,
the attention mask; atol 1e-5), then the whole detector on a 64×128 input
with depths (1, 1, 1, 1), in the tiny configuration of tests/test_rtdetr.py
(hidden 64, 4 heads, 20 queries, 2 decoder layers, ``arch="tpu"``). Flax
weights go through ``randomize_norm`` (BatchNorm and LayerNorm) and
``flax_to_state_dict`` into a strict load.

Detector tolerances (``_torch_parity.RTDETR_*_TOL``; float32): logits
rtol/atol 1e-4, normalised boxes atol 1e-5, pixel boxes atol 1e-2 px. The
top-k query selection must be the same as JAX's; the tests first assert
that JAX's k-th and (k+1)-th encoder scores are further apart than the
score tolerance, and that the scores inside the top k are further apart
than twice the largest difference between the two frameworks' scores, so
the comparison is well defined.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_rtdetr_outputs_match,
    assert_rtdetr_selection_well_defined,
    load_flax,
    randomize_norm,
    rtdetr_pair,
)
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.models import rtdetr as tr
from multimodal_moe_torch.ops import deformable_kernel
from multimodal_moe_tpu.models import rtdetr as jr

H, W = 64, 128
TINY = dict(hidden_dim=64, num_queries=20, num_decoder_layers=2, num_heads=4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0.0, scale, shape)).astype(np.float32)


def _init_module(jmod, *args):
    variables = jmod.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    return randomize_norm({"params": variables["params"], "batch_stats": {}}, seed=7)


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------

def test_encoder_layer_matches_flax():
    x, pos = _rand((2, 24, 64), 1), tr.sincos_2d(4, 6, 64)[None]
    jmod = jr.EncoderLayer(dim=64, num_heads=4, ffn_dim=256)
    variables = _init_module(jmod, x, pos)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(pos)))
    tmod = load_flax(tr.EncoderLayer(64, 4, 256), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


SHAPES = [(8, 12), (4, 6), (2, 3)]
SUM_HW = sum(h * w for h, w in SHAPES)


def _ref_points(b, q, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.1, 0.9, (b, q, 2)),
                           rng.uniform(0.05, 0.5, (b, q, 2))], -1).astype(np.float32)


def test_ms_deform_attn_matches_flax():
    query, values = _rand((2, 9, 64), 2), _rand((2, SUM_HW, 64), 3)
    ref_pts = _ref_points(2, 9, 4)
    jmod = jr.MSDeformAttn(dim=64, num_heads=4)
    variables = _init_module(jmod, query, ref_pts, values, SHAPES)
    # Non-zero offset weights, so that the locations depend on the query.
    variables["params"]["sampling_offsets"]["kernel"] = _rand((64, 96), 5, 0.2)
    ref = np.asarray(jmod.apply(variables, *(jnp.asarray(a) for a in (query, ref_pts, values)),
                                SHAPES))
    tmod = load_flax(tr.MSDeformAttn(64, 4), variables)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (query, ref_pts, values)), SHAPES).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_decoder_layer_matches_flax():
    query, pos, values = _rand((2, 9, 64), 6), _rand((2, 9, 64), 7), _rand((2, SUM_HW, 64), 8)
    ref_pts = _ref_points(2, 9, 9)
    jmod = jr.DecoderLayer(dim=64, num_heads=4)
    variables = _init_module(jmod, query, pos, ref_pts, values, SHAPES)
    variables["params"]["cross_attn"]["sampling_offsets"]["kernel"] = _rand((64, 96), 10, 0.2)
    ref = np.asarray(jmod.apply(
        variables, *(jnp.asarray(a) for a in (query, pos, ref_pts, values)), SHAPES))
    tmod = load_flax(tr.DecoderLayer(64, 4), variables)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (query, pos, ref_pts, values)), SHAPES).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_attention_mask_matches_flax():
    x = _rand((2, 6, 32), 11)
    mask = np.tril(np.ones((6, 6), bool))
    jmod = fnn.MultiHeadDotProductAttention(num_heads=4)
    variables = jmod.init(jax.random.PRNGKey(0), *(jnp.asarray(x),) * 3)
    ref = np.asarray(jmod.apply(variables, *(jnp.asarray(x),) * 3,
                                mask=jnp.asarray(mask)[None, None]))
    tmod = tr.MultiHeadAttention(32, 4)
    tmod.load_state_dict(flax_to_state_dict(jax.device_get(variables)), strict=True)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(x),) * 3, torch.from_numpy(mask)[None, None]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(2, 4), (22, 39)])
def test_sincos_anchors_and_grid_init_match(hw):
    np.testing.assert_array_equal(tr.sincos_2d(*hw, 256), jr.sincos_2d(*hw, 256))
    shapes = [(hw[0] * 4, hw[1] * 4), (hw[0] * 2, hw[1] * 2), hw]
    anchors, valid = tr.anchors_for(shapes)
    ref_anchors, ref_valid = jr.RTDETRDetector()._anchors(shapes)
    np.testing.assert_array_equal(anchors, np.asarray(ref_anchors))
    np.testing.assert_array_equal(valid, np.asarray(ref_valid))
    ref_bias = jr._grid_init(8, 3, 4)(jax.random.PRNGKey(0), (192,))
    np.testing.assert_array_equal(tr._grid_init(8, 3, 4), np.asarray(ref_bias))


def test_inverse_sigmoid_matches():
    x = np.linspace(-0.1, 1.1, 101).astype(np.float32)
    np.testing.assert_allclose(tr.inverse_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jr.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)


# --------------------------------------------------------------------------
# the detector (csp and full width: test_torch_rtdetr_configs.py)
# --------------------------------------------------------------------------

def valid_mask(h=H, w=W):
    return tr.anchors_for([(h // s, w // s) for s in (8, 16, 32)])[1]


@pytest.fixture(scope="module")
def pair():
    images = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return rtdetr_pair(TINY, 0, images)


def test_selection_is_well_defined(pair):
    assert_rtdetr_selection_well_defined(pair, valid_mask())


def test_detector_outputs_match_flax(pair):
    assert_rtdetr_outputs_match(pair)


def test_detector_cpu_path_takes_no_kernel(pair):
    """On the CPU the deformable sampling is the plain version: no launch."""
    before = deformable_kernel.ms_deform_fwd_launches
    with torch.inference_mode():
        pair.tmodel(torch.zeros((1, H, W, 3)))
    assert deformable_kernel.ms_deform_fwd_launches == before


def test_state_dict_round_trip(pair):
    """Every Flax leaf lands on a torch key and every torch key is filled."""
    check_state_dict_round_trip(pair)


def check_state_dict_round_trip(pair):
    cfg, variables = pair.cfg, pair.variables
    sd = flax_to_state_dict(variables)
    assert set(sd) == set(pair.tmodel.state_dict())
    assert "decoder0.self_attn.query.weight" in sd and "dn_content_embed" in sd
    c, nh = cfg["hidden_dim"], cfg["num_heads"]
    q_kernel = variables["params"]["decoder0"]["self_attn"]["query"]["kernel"]
    assert q_kernel.shape == (c, nh, c // nh)
    np.testing.assert_array_equal(sd["decoder0.self_attn.query.weight"].numpy(),
                                  q_kernel.reshape(c, c).T)
    out_kernel = variables["params"]["decoder0"]["self_attn"]["out"]["kernel"]
    np.testing.assert_array_equal(sd["decoder0.self_attn.out.weight"].numpy(),
                                  out_kernel.reshape(c, c).T)


def test_unmapped_leaf_raises():
    with pytest.raises(ValueError, match="unsupported parameter"):
        flax_to_state_dict({"params": {"layer": {"embedding": np.zeros((4, 8), np.float32)}}})
    with pytest.raises(ValueError, match="unsupported parameter"):
        flax_to_state_dict({"params": {"attn": {"proj": {"kernel": np.zeros((2, 3, 4))}}}})
    with pytest.raises(ValueError, match="unsupported variable collections"):
        flax_to_state_dict({"params": {}, "quant": {}})


def test_training_is_not_ported():
    model = tr.RTDETRDetector(num_classes=1, hidden_dim=64, num_queries=4,
                              num_decoder_layers=1, num_heads=4, backbone_depths=(1, 1, 1, 1))
    with pytest.raises(NotImplementedError, match="training slice"):
        model(torch.zeros((1, H, W, 3)), train=True,
              gt_boxes=torch.zeros((1, 2, 4)), gt_mask=torch.ones((1, 2), dtype=torch.bool))


def test_random_init_mirrors_flax_init():
    gen = torch.Generator().manual_seed(0)
    model = tr.RTDETRDetector(num_classes=1, hidden_dim=64, num_queries=4,
                              num_decoder_layers=2, num_heads=4, backbone_depths=(1, 1, 1, 1),
                              generator=gen)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["decoder1.cross_attn.sampling_offsets.bias"].numpy(),
                                  tr._grid_init(4, 3, 4))
    assert not sd["decoder1.cross_attn.sampling_offsets.weight"].any()
    assert (sd["cls_head0.bias"] == tr.CLS_PRIOR_BIAS).all()
    assert float(sd["dn_content_embed"].abs().max()) <= 0.04
    w = sd["decoder0.Dense_0.weight"]  # lecun normal: variance ≈ 1/fan_in
    assert abs(float(w.var()) * w.shape[1] - 1.0) < 0.1
