"""PyTorch port of ops/deformable.py and the deformable kernel's wrapper
against the JAX op and the Pallas kernel in interpret mode (CPU).

The problems are those of tests/test_deformable_pallas.py (in-range,
out-of-bounds and integer locations) and tests/test_rtdetr.py (a naive
per-point reference, an exact pixel centre, all out of bounds), and
locations that are NaN, ±inf or 1e30, which the Pallas kernel samples as
nothing. Tolerance atol 1e-5 (float32; the three sum the 4·L·P terms in
other orders). On CPU tensors the wrapper ``ms_deform_attn_fwd`` is the
plain version exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NON_FINITE, require_cuda, with_bad_locations
from multimodal_moe_torch.ops import deformable as td
from multimodal_moe_torch.ops import deformable_kernel as tk
from multimodal_moe_tpu.ops import deformable as jd
from multimodal_moe_tpu.ops.deformable_pallas import ms_deformable_attention_pallas

SHAPES = ((8, 12), (4, 6), (2, 3))
B, NH, D, P, Q = 2, 2, 8, 4, 7
L = len(SHAPES)
TOTAL = sum(h * w for h, w in SHAPES)
ATOL = 1e-5


def _problem(seed=0, loc_range=(-0.3, 1.3), shapes=SHAPES, b=B, nh=NH, d=D, p=P, q=Q):
    rng = np.random.default_rng(seed)
    total = sum(h * w for h, w in shapes)
    values = rng.normal(0, 1, (b, total, nh, d)).astype(np.float32)
    loc = rng.uniform(*loc_range, (b, q, nh, len(shapes), p, 2)).astype(np.float32)
    logits = rng.normal(0, 1, (b, q, nh, len(shapes) * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return values, loc, attn.reshape(b, q, nh, len(shapes), p).astype(np.float32)


def _integer_locations(seed=2):
    """Samples exactly on pixel centres: wx or wy is 0."""
    hw = np.asarray(SHAPES, np.float32)
    ij = np.random.default_rng(seed).integers(0, 2, (B, Q, NH, L, P, 2)).astype(np.float32)
    return ((ij + 0.5) / hw[None, None, None, :, None, ::-1]).astype(np.float32)


def _naive(values, shapes, loc, attn):
    """Per-point float64 reference: zero-padding bilinear, align_corners=False."""
    b, _, nh, d = values.shape
    q = loc.shape[1]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    out = np.zeros((b, q, nh, d))
    for bi, qi, hi in np.ndindex(b, q, nh):
        for li, (lh, lw) in enumerate(shapes):
            for pi in range(loc.shape[4]):
                x = float(loc[bi, qi, hi, li, pi, 0]) * lw - 0.5
                y = float(loc[bi, qi, hi, li, pi, 1]) * lh - 0.5
                x0, y0 = int(np.floor(x)), int(np.floor(y))
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    cx, cy = x0 + dx, y0 + dy
                    if 0 <= cx < lw and 0 <= cy < lh:
                        w = (x - x0 if dx else 1 - (x - x0)) * (y - y0 if dy else 1 - (y - y0))
                        out[bi, qi, hi] += (attn[bi, qi, hi, li, pi] * w
                                            * values[bi, starts[li] + cy * lw + cx, hi])
    return out.reshape(b, q, nh * d)


def _port(values, shapes, loc, attn):
    t = torch.from_numpy
    return td.ms_deformable_attention(t(values), shapes, t(loc), t(attn)).numpy()


@pytest.mark.parametrize("loc_range", [(0.1, 0.9), (-0.3, 1.3)])
def test_plain_matches_jax_and_pallas(loc_range):
    values, loc, attn = _problem(0, loc_range)
    got = _port(values, SHAPES, loc, attn)
    j = [jnp.asarray(a) for a in (values, loc, attn)]
    ref = np.asarray(jd.ms_deformable_attention(j[0], SHAPES, j[1], j[2]))
    pallas = np.asarray(ms_deformable_attention_pallas(j[0], SHAPES, j[1], j[2], True))
    assert got.shape == (B, Q, NH * D)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", sorted(NON_FINITE))
def test_non_finite_locations_match_pallas(bad):
    """A NaN, ±inf or 1e30 location samples nothing in the Pallas kernel
    (interpret mode): the output stays finite and equals the port's."""
    values, loc, attn = _problem(10)
    loc = with_bad_locations(loc, NON_FINITE[bad])
    got = tk.ms_deform_attn_fwd(torch.from_numpy(values), SHAPES,
                                torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    j = [jnp.asarray(a) for a in (values, loc, attn)]
    ref = np.asarray(ms_deformable_attention_pallas(j[0], SHAPES, j[1], j[2], True))
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_plain_integer_locations():
    values, _, attn = _problem(1)
    loc = _integer_locations()
    got = _port(values, SHAPES, loc, attn)
    j = [jnp.asarray(a) for a in (values, loc, attn)]
    np.testing.assert_allclose(
        got, np.asarray(jd.ms_deformable_attention(j[0], SHAPES, j[1], j[2])), atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(ms_deformable_attention_pallas(j[0], SHAPES, j[1], j[2], True)),
        atol=ATOL)


def test_plain_matches_naive_reference():
    # The case of tests/test_rtdetr.py: P=3, D=4, weights normalised per query.
    rng = np.random.default_rng(0)
    b, q, nh, d, p = 2, 5, 2, 4, 3
    values = rng.normal(size=(b, TOTAL, nh, d)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, q, nh, L, p, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (b, q, nh, L, p))
    w = (w / w.sum((-1, -2), keepdims=True)).astype(np.float32)
    got = _port(values, SHAPES, loc, w)
    np.testing.assert_allclose(got, _naive(values, SHAPES, loc, w), rtol=1e-4, atol=ATOL)


def test_exact_pixel_centre_and_all_out_of_bounds():
    shapes = [(4, 4)]
    values = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
    w = torch.ones((1, 1, 1, 1, 1))
    centre = torch.tensor([(2 + 0.5) / 4, (1 + 0.5) / 4]).reshape(1, 1, 1, 1, 1, 2)
    assert float(td.ms_deformable_attention(values, shapes, centre, w)[0, 0, 0]) == 1 * 4 + 2
    far = torch.full((1, 1, 1, 1, 1, 2), 2.0)
    ones = torch.ones((1, 16, 1, 1))
    assert float(td.ms_deformable_attention(ones, shapes, far, w)[0, 0, 0]) == 0.0
    assert float(tk.ms_deform_attn_fwd(values, [(4, 4)], far, w)[0, 0, 0]) == 0.0


@pytest.mark.parametrize("shapes", [SHAPES, ((2, 2),), ((8, 12), (4, 6), (2, 3), (2, 2))])
def test_level_offsets_match_jax(shapes):
    offsets, total = td.level_shapes_to_offsets(shapes)
    ref_offsets, ref_total = jd.level_shapes_to_offsets(shapes)
    assert offsets == np.asarray(ref_offsets).tolist() and total == ref_total


@pytest.mark.parametrize("seed,loc_range", [(3, (-0.3, 1.3)), (4, (0.0, 1.0))])
def test_wrapper_on_cpu_is_the_plain_version(seed, loc_range):
    values, loc, attn = (torch.from_numpy(a) for a in _problem(seed, loc_range))
    before = tk.ms_deform_fwd_launches
    got = tk.ms_deform_attn_fwd(values, SHAPES, loc, attn)
    assert torch.equal(got, td.ms_deformable_attention(values, SHAPES, loc, attn))
    assert tk.ms_deform_fwd_launches == before  # the plain version is no launch


def test_wrapper_rejects_bad_inputs():
    values, loc, attn = (torch.from_numpy(a) for a in _problem(5))
    with pytest.raises(TypeError, match="float32"):
        tk.ms_deform_attn_fwd(values.double(), SHAPES, loc, attn)
    with pytest.raises(TypeError, match="float32"):
        tk.ms_deform_attn_fwd(values, SHAPES, loc, attn.half())
    with pytest.raises(ValueError, match="loc must be"):
        tk.ms_deform_attn_fwd(values, SHAPES, loc[..., :1], attn)
    with pytest.raises(ValueError, match="values must be"):
        tk.ms_deform_attn_fwd(values[0], SHAPES, loc, attn)
    with pytest.raises(ValueError, match="Σ H_l·W_l"):
        tk.ms_deform_attn_fwd(values[:, :-1].contiguous(), SHAPES, loc, attn)
    with pytest.raises(ValueError, match="level shapes"):
        tk.ms_deform_attn_fwd(values, SHAPES[:2], loc, attn)
    with pytest.raises(ValueError, match="head dim 64 > 32"):
        tk.ms_deform_attn_fwd(torch.zeros(values.shape[:3] + (64,)), SHAPES, loc, attn)
    with pytest.raises(ValueError, match="contiguous"):
        tk.ms_deform_attn_fwd(values.transpose(0, 2).contiguous().transpose(0, 2),
                              SHAPES, loc, attn)
    # The Pallas wrapper's limit and message: every level at least 2×2.
    small = ((8, 12), (4, 6), (1, 6))
    with pytest.raises(ValueError, match=r"requires every level >= 2x2"):
        tk.ms_deform_attn_fwd(values, small, loc, attn)
    with pytest.raises(ValueError, match=r"requires every level >= 2x2"):
        ms_deformable_attention_pallas(jnp.asarray(values.numpy()), small,
                                       jnp.asarray(loc.numpy()), jnp.asarray(attn.numpy()),
                                       True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["test_shape", "headline_width", "integer", "non_finite",
                                  "d6_scalar", "d8_vector"])
def test_cuda_kernel_matches_plain(case):
    """B4 against the plain version on the card: the 16-byte path (D = 8,
    32), the scalar path (D = 6) and locations that are NaN, ±inf and 1e30."""
    dev = require_cuda()
    if case == "test_shape":
        shapes, (values, loc, attn) = SHAPES, _problem(6)
    elif case == "integer":
        values, _, attn = _problem(7)
        shapes, loc = SHAPES, _integer_locations(8)
    elif case == "non_finite":
        shapes, (values, loc, attn) = SHAPES, _problem(13, b=2, d=32, q=16)
        for i, bad in enumerate(NON_FINITE.values()):
            loc = with_bad_locations(loc, bad, q0=4 * i)
    elif case in ("d6_scalar", "d8_vector"):
        shapes = ((22, 39), (11, 20), (6, 10))
        values, loc, attn = _problem(14, shapes=shapes, b=2, nh=4, d=6 if case == "d6_scalar"
                                     else 8, p=4, q=40)
    else:
        shapes = ((22, 39), (11, 20), (6, 10))
        values, loc, attn = _problem(9, shapes=shapes, b=2, nh=8, d=32, p=4, q=50)
    values, loc, attn = (torch.from_numpy(a).to(dev) for a in (values, loc, attn))
    before = tk.ms_deform_fwd_launches
    got = tk.ms_deform_attn_fwd(values, shapes, loc, attn)
    torch.cuda.synchronize()
    assert tk.ms_deform_fwd_launches == before + 1
    ref = td.ms_deformable_attention(values, shapes, loc, attn)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
    tol = 1e-5 * max(1.0, float(values.abs().max()))
    assert float((got - ref).abs().max()) <= tol
