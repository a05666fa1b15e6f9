"""PyTorch port of models/resnet.py against the Flax ResNet (fp32, CPU).

The -vd variant RT-DETR uses, one bottleneck block per stage
(``stage_sizes=(1, 1, 1, 1)``), on a 64×128 input and on a 72×120 one whose
stride-8 (9×15) and stride-16 (5×8) maps have odd sides, so the avg-pool
shortcut pads and counts the padding; BatchNorms randomised so that the BN mapping is really checked. Tolerance rtol/atol
1e-4 (float32; the frameworks sum convolutions in other orders and the
deep ReLU trunk grows the values).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax, nchw, nhwc, randomize_norm
from multimodal_moe_torch.models import resnet as tr
from multimodal_moe_tpu.models import resnet as jr

@pytest.mark.parametrize("hw", [(64, 128), (72, 120)], ids=["vd", "vd_odd_maps"])
def test_stage_maps_match_flax(hw):
    images = np.random.default_rng(11).uniform(0.0, 1.0, (2, *hw, 3)).astype(np.float32)
    jmodel = jr.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=None, vd=True)
    variables = randomize_norm(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False), seed=3)
    ref = jax.device_get(jmodel.apply(variables, jnp.asarray(images), train=False))
    tmodel = load_flax(tr.ResNet(stage_sizes=(1, 1, 1, 1)), variables)
    with torch.no_grad():
        got = [nhwc(f) for f in tmodel(nchw(images))]
    assert [g.shape for g in got] == [np.asarray(r).shape for r in ref]
    assert [g.shape[-1] for g in got] == tmodel.out_channels
    for i, (g, r) in enumerate(zip(got, ref)):
        assert np.abs(r).max() > 0.1, f"stage {i} faded"
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=f"stage {i}")


def test_resnet50_names_load_strictly():
    """The full r50-vd tree maps name for name (shapes only, no forward)."""
    jmodel = jr.resnet50(num_classes=None, vd=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tmodel = load_flax(tr.resnet50(num_classes=None, vd=True), variables)
    assert tmodel.out_channels == [256, 512, 1024, 2048]
    assert len([n for n in tmodel.state_dict() if n.endswith("Conv_0.weight")]) == 3 + 16 * 3 + 4


@pytest.mark.parametrize("hw", [(8, 12), (7, 12), (8, 9), (5, 5)])
def test_avg_pool_same_counts_padding(hw):
    x = np.random.default_rng(sum(hw)).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(fnn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2), padding="SAME"))
    got = nhwc(tr.avg_pool_2x2_same(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
