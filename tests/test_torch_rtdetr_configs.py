"""PyTorch port of RT-DETR against Flax in two more configurations (fp32,
CPU), on a 64×128 input with depths (1, 1, 1, 1):

* ``csp``: the tiny configuration (hidden 64, 4 heads, 20 queries, 2
  decoder layers) with CSP fusion stages (``arch="csp"``);
* ``full-width``: hidden 256 and 8 heads, so each head is D=32 wide, the
  width the deformable kernel serves; 100 queries, 2 decoder layers.

Tolerances and the check that the top-k selection is well defined are
those of tests/test_torch_rtdetr.py (``_torch_parity.RTDETR_*_TOL``).
"""

import numpy as np
import pytest

from _torch_parity import (
    assert_rtdetr_outputs_match,
    assert_rtdetr_selection_well_defined,
    rtdetr_pair,
)
from test_torch_rtdetr import check_state_dict_round_trip, valid_mask

H, W = 64, 128
CONFIGS = {
    "csp": dict(hidden_dim=64, num_queries=20, num_decoder_layers=2, num_heads=4, arch="csp"),
    "full-width": dict(hidden_dim=256, num_queries=100, num_decoder_layers=2, num_heads=8),
}
SEEDS = {"csp": 1, "full-width": 2}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    name = request.param
    images = np.random.default_rng(SEEDS[name]).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return rtdetr_pair(CONFIGS[name], SEEDS[name], images)


def test_selection_is_well_defined(pair):
    assert_rtdetr_selection_well_defined(pair, valid_mask(H, W))


def test_detector_outputs_match_flax(pair):
    assert_rtdetr_outputs_match(pair)


def test_state_dict_round_trip(pair):
    check_state_dict_round_trip(pair)
