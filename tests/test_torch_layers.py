"""PyTorch port of models/layers.py against the Flax layers (fp32, CPU).

Each Flax module is initialised, its BatchNorms randomised, converted with
``flax_to_state_dict`` and loaded strictly into the torch twin. Tolerance:
atol 1e-5 (float32; the two frameworks sum convolutions in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax, nchw, nhwc, randomize_norm
from multimodal_moe_torch.models import layers as tl
from multimodal_moe_tpu.models import layers as jl

ATOL = 1e-5


def _input(shape, seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


CASES = {
    "conv3x3": (lambda: jl.ConvBNAct(16, 3), lambda: tl.ConvBNAct(8, 16, 3), 8),
    "conv3x3_s2": (
        lambda: jl.ConvBNAct(16, 3, strides=2), lambda: tl.ConvBNAct(8, 16, 3, strides=2), 8,
    ),
    "conv1x1_noact": (
        lambda: jl.ConvBNAct(12, 1, act=False), lambda: tl.ConvBNAct(8, 12, 1, act=False), 8,
    ),
    "bottleneck": (lambda: jl.Bottleneck(8), lambda: tl.Bottleneck(8, 8), 8),
    "bottleneck_widen": (lambda: jl.Bottleneck(16), lambda: tl.Bottleneck(8, 16), 8),
    "csp": (lambda: jl.CSPStage(16, 2), lambda: tl.CSPStage(8, 16, 2), 8),
    "csp_noshort": (
        lambda: jl.CSPStage(16, 1, shortcut=False),
        lambda: tl.CSPStage(24, 16, 1, shortcut=False), 24,
    ),
    "sppf": (lambda: jl.SPPF(16), lambda: tl.SPPF(8, 16), 8),
    "stem": (lambda: jl.SpaceToDepthStem(16, ratio=4), lambda: tl.SpaceToDepthStem(3, 16, 4), 3),
    "plain": (lambda: jl.PlainStage(8, 2), lambda: tl.PlainStage(8, 8, 2), 8),
    "plain_reduce": (
        lambda: jl.PlainStage(8, 1, shortcut=False),
        lambda: tl.PlainStage(24, 8, 1, shortcut=False), 24,
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax(name):
    make_j, make_t, cin = CASES[name]
    x = _input((2, 16, 24, cin), seed=len(name))
    jmod = make_j()
    variables = randomize_norm(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), seed=1
    )
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    tmod = load_flax(make_t(), variables)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_flax_names_are_torch_names():
    """Every Flax leaf path maps onto a torch key and back (strict load)."""
    jmod = jl.CSPStage(16, 2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)), train=False)
    keys = set(tl.CSPStage(8, 16, 2).state_dict())
    assert "Bottleneck_1.ConvBNAct_0.conv.weight" in keys
    assert "ConvBNAct_1.bn.running_var" in keys
    load_flax(tl.CSPStage(8, 16, 2), jax.device_get(variables))


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_channel_order(r):
    """(dy, dx, c) order on NHWC, not pixel_unshuffle's (c, dy, dx)."""
    x = _input((2, 8, 12, 3), seed=r)
    ref = np.asarray(jl.space_to_depth(jnp.asarray(x), r))
    got = nhwc(tl.space_to_depth(nchw(x), r))
    np.testing.assert_array_equal(got, ref)
    # The exact place of one pixel: (y, x, c) = (1, 2, 1) lands at channel
    # (dy·r + dx)·C + c of cell (0, 0) when r > 2.
    if r == 4:
        assert got[0, 0, 0, (1 * r + 2) * 3 + 1] == x[0, 1, 2, 1]


def test_upsample2x():
    x = _input((2, 5, 7, 4))
    ref = np.asarray(jl.upsample2x(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tl.upsample2x(nchw(x))), ref)


@pytest.mark.parametrize("k,d", [(1, 1), (3, 1), (5, 1), (3, 2)])
def test_autopad(k, d):
    assert tl.autopad(k, d) == jl.autopad(k, d)
