"""The deformable-attention backward of the PyTorch port against JAX (CPU).

``ms_deform_attn_bwd_plain`` (dv and the per-corner sums s) followed by
``ms_deform_attn_loc_attn_grads`` (d_loc, d_attn) is compared with
``jax.vjp`` of the Pallas op in interpret mode (its ``_bwd_rule``) and of
the XLA op ``ms_deformable_attention``, on the problems of
tests/test_deformable_pallas.py: locations in (0.1, 0.9) and (−0.3, 1.3),
and exactly on pixel centres. Tolerance: that test's own, atol 3e-5·scale
with scale = max(1, max|JAX gradient|) per gradient (float32; the three
sum in other orders).

The autograd function behind ``ms_deform_attn_fwd`` is checked against
torch autograd through the plain forward (atol 1e-5·scale), and an input
that requires grad gets a ``grad_fn`` through it. Locations that are NaN,
±inf or 1e30 get JAX's Pallas gradients (``d_loc = 0``, ``d_attn = 0`` at a
point outside the map). ``deform_bwd_tolerance`` is pinned against a
float64 evaluation. A card-only test holds kernel B5, which computes
``(dv, d_loc, d_attn)`` in one launch, against the plain backward.
"""

import jax
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
TOL = 3e-5  # times max(1, max|ref|): tests/test_deformable_pallas.py


def _problem(seed, loc_range=(-0.3, 1.3), shapes=SHAPES, b=B, nh=NH, d=D, p=P, q=Q,
             centres=False):
    rng = np.random.default_rng(seed)
    total = sum(h * w for h, w in shapes)
    values = rng.normal(0, 1, (b, total, nh, d)).astype(np.float32)
    shape = (b, q, nh, len(shapes), p)
    if centres:
        hw = np.asarray(shapes, np.float64)[None, None, None, :, None, ::-1]  # (W, H)
        loc = (np.floor(rng.uniform(0, 1, shape + (2,)) * hw) + 0.5) / hw
    else:
        loc = rng.uniform(*loc_range, shape + (2,))
    logits = rng.normal(0, 1, (b, q, nh, len(shapes) * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    g = rng.normal(0, 1, (b, q, nh * d)).astype(np.float32)
    return (values, loc.astype(np.float32), attn.reshape(shape).astype(np.float32), g)


def _port_grads(values, loc, attn, g, shapes=SHAPES):
    t = [torch.from_numpy(a) for a in (values, loc, attn, g)]
    dv, s = td.ms_deform_attn_bwd_plain(t[0], shapes, t[1], t[2], t[3])
    d_loc, d_attn = td.ms_deform_attn_loc_attn_grads(shapes, t[1], t[2], s)
    return dv.numpy(), d_loc.numpy(), d_attn.numpy()


def _jax_grads(fn, values, loc, attn, g):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (values, loc, attn)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_close(got, ref, what):
    for name, a, b in zip(("dv", "d_loc", "d_attn"), got, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0, err_msg=f"{what} {name}")


CASES = {"inside": dict(loc_range=(0.1, 0.9)), "out_of_bounds": dict(loc_range=(-0.3, 1.3)),
         "pixel_centres": dict(centres=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_bwd_rule(case):
    values, loc, attn, g = _problem(3, **CASES[case])
    ref = _jax_grads(lambda v, l, a: ms_deformable_attention_pallas(v, SHAPES, l, a, True),
                     values, loc, attn, g)
    _assert_close(_port_grads(values, loc, attn, g), ref, f"pallas {case}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_xla_grad(case):
    values, loc, attn, g = _problem(4, **CASES[case])
    ref = _jax_grads(lambda v, l, a: jd.ms_deformable_attention(v, SHAPES, l, a),
                     values, loc, attn, g)
    _assert_close(_port_grads(values, loc, attn, g), ref, f"xla {case}")


def _pallas(v, loc, a):
    return ms_deformable_attention_pallas(v, SHAPES, loc, a, True)


@pytest.mark.parametrize("bad", sorted(NON_FINITE))
def test_non_finite_locations_match_pallas_grad(bad):
    """NaN, ±inf and 1e30 in ``loc``: the port's gradients through
    ``ms_deform_attn_fwd``'s autograd on the CPU are finite and equal
    ``jax.vjp`` of the Pallas op; a point with a non-finite coordinate gets
    ``d_loc = 0`` and ``d_attn = 0`` exactly."""
    values, loc, attn, g = _problem(13)
    loc = with_bad_locations(loc, NON_FINITE[bad])
    ref = _jax_grads(_pallas, values, loc, attn, g)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (values, loc, attn)]
    out = tk.ms_deform_attn_fwd(inputs[0], SHAPES, inputs[1], inputs[2])
    got = [t.numpy() for t in torch.autograd.grad(out, inputs, torch.from_numpy(g))]
    for name, a in zip(("dv", "d_loc", "d_attn"), got):
        assert np.isfinite(a).all(), name
    _assert_close(got, ref, f"pallas {bad}")
    if not np.isfinite(NON_FINITE[bad]):
        bad_points = ~np.isfinite(loc).all(-1)
        assert bad_points.sum() == 3
        assert not got[1][bad_points].any() and not got[2][bad_points].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_wrapper_returns_the_fused_triple(case):
    """``ms_deform_attn_bwd`` on the CPU returns ``(dv, d_loc, d_attn)``:
    the plain backward and its elementwise part exactly, and ``_bwd_rule``'s
    triple within the Pallas test's tolerance."""
    arrays = _problem(14, **CASES[case])
    values, loc, attn, g = (torch.from_numpy(a) for a in arrays)
    got = tk.ms_deform_attn_bwd(values, SHAPES, loc, attn, g)
    assert [tuple(t.shape) for t in got] == [tuple(values.shape), tuple(loc.shape),
                                            tuple(attn.shape)]
    for a, b in zip(got, _port_grads(*arrays)):
        assert np.array_equal(a.numpy(), b)
    _assert_close([t.numpy() for t in got], _jax_grads(_pallas, *arrays), f"_bwd_rule {case}")


TOLERANCE_CASES = {"test_shape": {}, "one_pixel": {"one_pixel": True},
                   "values_1e4": {"scale": 1e4}}


@pytest.mark.parametrize("case", sorted(TOLERANCE_CASES))
def test_fused_tolerance_holds_against_float64(case):
    """The per-element bound on ``d_loc`` and ``d_attn`` that the card's
    fused kernel is held to (``deform_bwd_tolerance``) holds for the float32
    plain version against a float64 evaluation of the same sums (the float32
    bilinear weights kept): at the JAX test shape, with every sample on one
    pixel, and with values of 1e4."""
    opts = TOLERANCE_CASES[case]
    values, loc, attn, g = _problem(15)
    values = values * np.float32(opts.get("scale", 1.0))
    if opts.get("one_pixel"):
        loc[:] = np.array([0.37, 0.61], np.float32)
    t = [torch.from_numpy(a) for a in (values, loc, attn, g)]
    got = tk.ms_deform_attn_bwd(t[0], SHAPES, t[1], t[2], t[3])
    dv64, s64 = td.ms_deform_attn_bwd_plain(t[0].double(), SHAPES, t[1], t[2].double(),
                                            t[3].double())
    exact = td.ms_deform_attn_loc_attn_grads(SHAPES, t[1], t[2].double(), s64)
    _, d_loc_tol, d_attn_tol = tk.deform_bwd_tolerance(t[0], SHAPES, t[1], t[2], t[3])
    for name, a, ref, tol in (("d_loc", got[1], exact[0], d_loc_tol),
                              ("d_attn", got[2], exact[1], d_attn_tol)):
        err = (a.double() - ref).abs()
        assert bool((err <= tol).all()), (name, float((err / tol).max()))
        # The bound is a few ulps of the terms, not a loose constant.
        assert float(tol.max()) <= 1e-5 * max(1.0, float(ref.abs().max())), name


def test_out_of_bounds_corners_have_zero_sums():
    values, loc, attn, g = (torch.from_numpy(a) for a in _problem(5))
    _, s = td.ms_deform_attn_bwd_plain(values, SHAPES, loc, attn, g)
    for c, (_, _, _, inside, _) in enumerate(td._corners(SHAPES, loc)):
        assert not s[..., c][~inside].any()
        assert s[..., c][inside].abs().min() > 0


@pytest.mark.parametrize("seed,loc_range", [(6, (-0.3, 1.3)), (7, (0.1, 0.9))])
def test_autograd_function_matches_torch_autograd(seed, loc_range):
    """The CPU route of the autograd function against autograd through the
    plain forward (gathers and multiplies; the same function)."""
    values, loc, attn, g = (torch.from_numpy(a) for a in _problem(seed, loc_range))
    grads = []
    for fn in (tk.ms_deform_attn_fwd, td.ms_deformable_attention):
        inputs = [t.clone().requires_grad_() for t in (values, loc, attn)]
        out = fn(inputs[0], SHAPES, inputs[1], inputs[2])
        grads.append(torch.autograd.grad(out, inputs, g))
    for name, got, ref in zip(("dv", "d_loc", "d_attn"), *grads):
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= 1e-5 * scale, name


def test_gradient_flows_through_the_wrapper():
    """An input that requires grad gets a grad_fn (a forward-only wrapper
    that writes through ctypes into a fresh tensor would cut the gradient on
    the card), and the backward count moves only on the card."""
    values, loc, attn, g = (torch.from_numpy(a) for a in _problem(8))
    values.requires_grad_()
    out = tk.ms_deform_attn_fwd(values, SHAPES, loc, attn)
    assert out.grad_fn is not None and out.requires_grad
    before = tk.ms_deform_bwd_launches
    out.backward(g)
    assert values.grad is not None and values.grad.abs().max() > 0
    assert tk.ms_deform_bwd_launches == before
    with torch.no_grad():
        assert tk.ms_deform_attn_fwd(values, SHAPES, loc, attn).grad_fn is None


def test_bwd_wrapper_rejects_bad_cotangent():
    values, loc, attn, g = (torch.from_numpy(a) for a in _problem(9))
    with pytest.raises(ValueError, match="g must be"):
        tk.ms_deform_attn_bwd(values, SHAPES, loc, attn, g[:, :-1])
    with pytest.raises(TypeError, match="float32"):
        tk.ms_deform_attn_bwd(values, SHAPES, loc, attn, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        tk.ms_deform_attn_bwd(values, SHAPES, loc, attn, g.transpose(0, 1).contiguous()
                              .transpose(0, 1))
    dv, d_loc, d_attn = tk.ms_deform_attn_bwd(values, SHAPES, loc, attn, g)
    assert dv.shape == values.shape and d_loc.shape == loc.shape and d_attn.shape == attn.shape


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["test_shape", "centres", "training_width", "non_finite",
                                  "d6_scalar", "d8_vector"])
def test_cuda_backward_matches_plain(case):
    """B5's ``(dv, d_loc, d_attn)`` from one launch against the plain
    backward and its elementwise part, on the 16-byte path (D = 8, 32), the
    scalar path (D = 6) and with NaN, ±inf and 1e30 locations."""
    dev = require_cuda()
    shapes = SHAPES
    if case == "test_shape":
        arrays = _problem(10)
    elif case == "centres":
        arrays = _problem(11, centres=True)
    elif case == "non_finite":
        values, loc, attn, g = _problem(16, b=2, d=32, q=16)
        for i, bad in enumerate(NON_FINITE.values()):
            loc = with_bad_locations(loc, bad, q0=4 * i)
        arrays = (values, loc, attn, g)
    elif case in ("d6_scalar", "d8_vector"):
        shapes = ((22, 39), (11, 20), (6, 10))
        arrays = _problem(17, shapes=shapes, b=2, nh=4, d=6 if case == "d6_scalar" else 8, p=4,
                          q=40)
    else:
        shapes = ((22, 39), (11, 20), (6, 10))
        arrays = _problem(12, shapes=shapes, b=2, nh=8, d=32, p=4, q=80)
    values, loc, attn, g = (torch.from_numpy(a).to(dev) for a in arrays)
    before = tk.ms_deform_bwd_launches
    got = tk.ms_deform_attn_bwd(values, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert tk.ms_deform_bwd_launches == before + 1
    ref_dv, ref_s = td.ms_deform_attn_bwd_plain(values, shapes, loc, attn, g)
    ref = (ref_dv, *td.ms_deform_attn_loc_attn_grads(shapes, loc, attn, ref_s))
    # fp32 atomics add in run-dependent order, and the kernel sums each
    # corner's dot in another order: each element within 2·n·u·Σ|terms|.
    tols = tk.deform_bwd_tolerance(values, shapes, loc, attn, g)
    for name, a, r, tol in zip(("dv", "d_loc", "d_attn"), got, ref, tols):
        assert bool(torch.isfinite(a).all()), name
        err = (a - r).abs()
        assert bool((err <= tol).all()), name
        assert float(err.max()) <= 1e-5 * max(1.0, float(r.abs().max())), name
