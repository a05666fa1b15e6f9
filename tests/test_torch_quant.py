"""The port's int8 PTQ primitives (``multimodal_moe_torch/quant.py``,
``ops/int8_conv.py``, ``models/layers.apply_i8_epilogue``) against the JAX
package's on the CPU: quantize/dequantize/concat/split bit for bit; the exact
int32 conv against ``lax.conv_general_dilated(..., preferred_element_type=
int32)``; the epilogue's four modes; BN folding and ``build_quant_variables``
from JAX's own calibration statistics, every leaf bit for bit; ``calibrate``
in both modes; the npz files both ways. The JAX side is YOLO-n at 64×96, as
``tests/test_quant.py`` runs it. Flax modules are imported inside the CPU
tests, so that the card test collects where JAX is installed without Flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_int8 import (
    calib_images,
    epilogue,
    jax_apply,
    jax_quantize,
    port_apply,
    trees_equal,
    two_threads,  # noqa: F401  (autouse)
)
from _torch_parity import numpy_variables, require_cuda
from multimodal_moe_torch import quant as tq
from multimodal_moe_torch.convert import flax_to_state_dict, quant_tree_to_state_dict
from multimodal_moe_torch.models.layers import apply_i8_epilogue
from multimodal_moe_torch.models.yolo import YoloDetector as TorchYolo
from multimodal_moe_torch.ops import int8_conv
from multimodal_moe_tpu import quant as jq

H, W = 64, 96


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def _halfway(rng, n, s):
    """Values at exact halves of the step ``s`` (round-half-even decides)
    and far past the clip, beside random ones."""
    k = rng.integers(-140, 140, n)
    return np.concatenate([(k + 0.5) * s, rng.normal(0, 60 * s, n), [1e9, -1e9, 0.0]]).astype(
        np.float32)


def test_quantize_dequantize_match_jax():
    rng = np.random.default_rng(0)
    s = np.float32(0.037)
    x = _halfway(rng, 2000, s)
    ref = np.asarray(jq.quantize_to(jnp.asarray(x), jnp.asarray(s)))
    got = tq.quantize_to(torch.from_numpy(x), torch.tensor(s)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    qt = tq.QT(torch.from_numpy(got), torch.tensor(s))
    np.testing.assert_array_equal(tq.dequantize(qt).numpy(),
                                  np.asarray(jq.dequantize(jq.QT(jnp.asarray(ref), jnp.asarray(s)))))


def test_q_from_images_matches_jax():
    rng = np.random.default_rng(1)
    images = rng.random((2, 8, 12, 3), np.float32)
    images[0, 0, :, 0] = (np.arange(12) + 0.5) / 127.0     # near-halfway codes
    ref = jq.q_from_images(jnp.asarray(images))
    got = tq.q_from_images(torch.from_numpy(images))
    assert got.q.shape == (2, 3, 8, 12) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.permute(0, 2, 3, 1).numpy(), np.asarray(ref.q))
    assert got.s.dtype == torch.float32 and float(got.s) == float(ref.s)


@pytest.mark.parametrize("shared", [True, False], ids=["one_scale", "three_scales"])
def test_qcat_and_split_match_jax(shared):
    rng = np.random.default_rng(2)
    qs = [rng.integers(-127, 128, (2, 4, 5, c)).astype(np.int8) for c in (4, 6, 2)]
    scales = [np.float32(0.02)] * 3 if shared else [np.float32(v) for v in (0.02, 0.05, 0.031)]
    if shared:
        s_t = torch.tensor(scales[0])
        parts_t = [tq.QT(torch.from_numpy(q).permute(0, 3, 1, 2), s_t) for q in qs]
        s_j = jnp.asarray(scales[0])
        parts_j = [jq.QT(jnp.asarray(q), s_j) for q in qs]
    else:
        parts_t = [tq.QT(torch.from_numpy(q).permute(0, 3, 1, 2), torch.tensor(s))
                   for q, s in zip(qs, scales)]
        parts_j = [jq.QT(jnp.asarray(q), jnp.asarray(s)) for q, s in zip(qs, scales)]
    got, ref = tq.qcat(parts_t), jq.qcat(parts_j)
    np.testing.assert_array_equal(got.q.permute(0, 2, 3, 1).numpy(), np.asarray(ref.q))
    assert float(got.s) == float(ref.s)
    if shared:
        assert got.s is parts_t[0].s      # the shortcut: no rescale
    a, b = tq.q_split2(got)
    ja, jb = jq.q_split2(ref)
    np.testing.assert_array_equal(a.q.permute(0, 2, 3, 1).numpy(), np.asarray(ja.q))
    np.testing.assert_array_equal(b.q.permute(0, 2, 3, 1).numpy(), np.asarray(jb.q))
    assert a.s is got.s and b.s is got.s


# --------------------------------------------------------------------------
# the exact int8 conv
# --------------------------------------------------------------------------

CONV_CASES = [
    # (b, h, w, cin, cout, k, stride): K = k*k*cin and N = cout off multiples
    # of 8, M = b*Ho*Wo at or below 16, and the 432-deep stem
    (2, 9, 11, 5, 3, 3, 1),
    (2, 9, 11, 5, 3, 3, 2),
    (2, 9, 11, 5, 3, 1, 1),
    (2, 9, 11, 5, 3, 1, 2),
    (1, 4, 3, 16, 24, 3, 1),
    (1, 4, 4, 13, 1, 1, 2),
    (2, 6, 8, 48, 64, 3, 1),
    (2, 6, 8, 32, 64, 1, 1),
]


def _conv_case(b, h, w, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    w_hwio = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    return q, w_hwio


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "b{}_{}x{}_c{}_o{}_k{}_s{}".format(*c))
def test_int8_conv2d_matches_lax(case):
    b, h, w, cin, cout, k, stride = case
    q, w_hwio = _conv_case(b, h, w, cin, cout, k, seed=sum(case))
    p = k // 2
    ref = np.asarray(lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w_hwio), (stride, stride), ((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    qt = torch.from_numpy(q).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    got = int8_conv.int8_conv2d(qt, wt, stride, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(int8_conv.int8_conv2d_plain(qt, wt, stride, p).numpy(),
                                  got.numpy())


def test_int8_conv2d_batch_chunks(monkeypatch):
    """The im2col budget splits the batch without changing a bit."""
    q, w_hwio = _conv_case(5, 7, 9, 12, 10, 3, seed=7)
    qt = torch.from_numpy(q).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    whole = int8_conv.int8_conv2d(qt, wt, 1, 1)
    monkeypatch.setattr(int8_conv, "IM2COL_BUDGET_BYTES", 2 * 7 * 9 * 112)
    np.testing.assert_array_equal(int8_conv.int8_conv2d(qt, wt, 1, 1).numpy(), whole.numpy())


def test_int8_conv2d_extreme_codes():
    """Every code at ±127: the largest sums are exact."""
    q = np.full((2, 5, 5, 64), 127, np.int8)
    q[1] = -127
    w = np.full((3, 3, 64, 16), -127, np.int8)
    qt = torch.from_numpy(q).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = int8_conv.int8_conv2d(qt, wt, 1, 1)
    assert int(got[0, 0, 2, 2]) == -127 * 127 * 9 * 64
    np.testing.assert_array_equal(got.numpy(), int8_conv.int8_conv2d_plain(qt, wt, 1, 1).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "b{}_{}x{}_c{}_o{}_k{}_s{}".format(*c))
def test_cuda_int8_conv2d_matches_float64(case):
    """On the card: ``torch._int_mm`` (cuBLASLt) with the padding against the
    float64 convolution, bit for bit."""
    dev = require_cuda()
    b, h, w, cin, cout, k, stride = case
    q, w_hwio = _conv_case(b, h, w, cin, cout, k, seed=sum(case))
    qt = torch.from_numpy(q).permute(0, 3, 1, 2).to(dev)
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).to(dev)
    got = int8_conv.int8_conv2d(qt, wt, stride, k // 2)
    assert torch.equal(got, int8_conv.int8_conv2d_plain(qt, wt, stride, k // 2))


# --------------------------------------------------------------------------
# the epilogue
# --------------------------------------------------------------------------

def test_int32_to_bf16_matches_xla():
    """XLA on the CPU converts int32 → bf16 through float32 (two roundings
    above 2^24), as torch does: equal at every magnitude."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(-2**31 + 1, 2**31 - 1, 200_000),
                        rng.integers(-2**26, 2**26, 200_000),
                        [2**24 + 1, 2**24 + 3, 2**25 + 2**17 + 1, -(2**25 + 2**17 + 1)]]
                       ).astype(np.int32)
    ref = np.asarray(jax.jit(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32))(v))
    got = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, ref)


EPILOGUE_CASES = [(True, "silu"), (False, "silu"), (True, "relu"), (False, "relu")]


@pytest.mark.parametrize("mode", ["bf16", "silu", "hswish", "linear"])
@pytest.mark.parametrize("act,kind", EPILOGUE_CASES)
def test_epilogue_matches_jax(mode, act, kind):
    """Codes equal to the jitted JAX epilogue's in every mode; accumulators
    up to 2^28 (past float32's and bf16's exact integers)."""
    from multimodal_moe_tpu.models.layers import apply_i8_epilogue as jax_epilogue

    rng = np.random.default_rng(4)
    y32 = np.concatenate([rng.integers(-40000, 40000, (2, 8, 8, 32)),
                          rng.integers(-2**28, 2**28, (2, 8, 8, 32))]).astype(np.int32)
    scale = rng.uniform(1e-5, 1e-4, 32).astype(np.float32)
    big = np.abs(y32) > 2**20
    bias = rng.normal(0, 0.3, 32).astype(np.float32)
    s_out = np.float32(0.02)
    with epilogue(mode):
        ref = np.asarray(jax.jit(
            lambda a, b, c, d: jax_epilogue(a, b, c, act, d, act_kind=kind))(y32, scale, bias, s_out))
        got = apply_i8_epilogue(torch.from_numpy(y32), torch.from_numpy(scale),
                                torch.from_numpy(bias), act, torch.tensor(s_out), kind)
    assert got.dtype == torch.int8 and big.any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unknown_epilogue_mode_raises():
    with epilogue("fp8"), pytest.raises(ValueError, match="MMOE_I8_EPILOGUE"):
        apply_i8_epilogue(torch.zeros(4, dtype=torch.int32), torch.ones(()), torch.zeros(()),
                          True, torch.ones(()))


# --------------------------------------------------------------------------
# calibration, folding, the quant tree, the npz files (YOLO-n, 64x96)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo():
    from multimodal_moe_tpu.models.yolo import YoloDetector as JaxYolo

    jm = JaxYolo(num_classes=1, variant="n")
    jmq = JaxYolo(num_classes=1, variant="n", int8=True)
    variables = numpy_variables(jm, jnp.zeros((1, H, W, 3)), train=False, seed=5)
    images = calib_images(3, H, W, seed=6)
    qcal, qvars = jax_quantize(jm, jmq, variables, images)
    fp = TorchYolo(num_classes=1, variant="n")
    fp.load_state_dict(flax_to_state_dict(variables), strict=True)
    return dict(jm=jm, jmq=jmq, variables=variables, images=images, qcal=qcal, qvars=qvars,
                fp=fp.eval(), q=TorchYolo(num_classes=1, variant="n", int8=True).eval())


def test_build_quant_variables_from_jax_qcal_bitwise(yolo):
    """BN folding and per-channel weight quantization on JAX's own
    statistics: every leaf of the tree equal to JAX's, dtype included."""
    got = tq.build_quant_variables(yolo["q"], yolo["fp"].state_dict(), yolo["qcal"])
    trees_equal(got, yolo["qvars"])


@pytest.mark.parametrize("mode", ["absmax", "avgmax"])
def test_calibrate_matches_jax(yolo, mode):
    ref = jax.device_get(jq.calibrate(yolo["jm"], yolo["variables"],
                                      [jnp.asarray(x) for x in yolo["images"]], mode=mode))
    got = tq.calibrate(yolo["fp"], yolo["images"], mode=mode)
    fr, fg = tq.flatten(ref), tq.flatten(got)
    assert set(fr) == set(fg)
    for k in fr:
        np.testing.assert_allclose(fg[k], fr[k], rtol=1e-5, atol=0, err_msg=k)
    assert not tq.recording()


def test_calibrate_rejects_bad_input(yolo):
    with pytest.raises(ValueError, match="mode"):
        tq.calibrate(yolo["fp"], yolo["images"], mode="percentile")
    with pytest.raises(ValueError, match="batch"):
        tq.calibrate(yolo["fp"], [])


def test_every_quant_leaf_filled(yolo):
    """The counterpart of tests/test_quant.py::test_every_quant_leaf_filled:
    the strict load fills every quant tensor of the int8 model."""
    model = TorchYolo(num_classes=1, variant="n", int8=True)
    tq.load_serving(model, yolo["qvars"])
    n_conv = 0
    for path, leaf, t in tq.quant_leaves(model):
        name = f"{path}.{leaf}"
        if leaf == "s_out" or leaf.startswith("s_add"):
            assert float(t.min()) > 0 and not torch.allclose(t, torch.ones(())), name
        if leaf == "w_q":
            n_conv += 1
            assert t.dtype == torch.int8 and int(t.abs().max()) == 127, name
    assert n_conv > 20
    sd = quant_tree_to_state_dict(yolo["qvars"])
    assert set(sd) == set(model.state_dict())


def test_build_checks_shapes(yolo):
    wide = TorchYolo(num_classes=2, variant="n", int8=True)
    with pytest.raises(ValueError, match="shape"):
        tq.build_quant_variables(wide, yolo["fp"].state_dict(), yolo["qcal"])


def test_npz_jax_to_port(yolo, tmp_path):
    """A file JAX's save_quant_npz wrote loads in the port as the same tree
    and gives the same forward as the tree the port builds from the same
    statistics."""
    path = tmp_path / "int8_quant.npz"
    jq.save_quant_npz(path, yolo["qvars"])
    loaded = tq.load_quant_npz(path)
    trees_equal(loaded, yolo["qvars"])
    own = tq.build_quant_variables(yolo["q"], yolo["fp"].state_dict(), yolo["qcal"])
    a = tq.load_serving(TorchYolo(num_classes=1, variant="n", int8=True).eval(), loaded)
    b = tq.load_serving(TorchYolo(num_classes=1, variant="n", int8=True).eval(), own)
    x = torch.from_numpy(yolo["images"][0])
    out_a, out_b = port_apply(a, x, "bf16"), port_apply(b, x, "bf16")
    for k in ("box_logits", "cls_logits", "boxes"):
        assert torch.equal(out_a[k], out_b[k]), k


def test_npz_port_to_jax(yolo, tmp_path):
    """A file the port wrote loads in JAX and drives JAX's int8 forward."""
    tree = tq.build_quant_variables(yolo["q"], yolo["fp"].state_dict(), yolo["qcal"])
    path = tmp_path / "int8_quant_best.npz"
    tq.save_quant_npz(path, tree)
    loaded = jax.device_get(jq.load_quant_npz(path))
    trees_equal(loaded, yolo["qvars"])
    x = jnp.asarray(yolo["images"][0])
    a = jax_apply(yolo["jmq"], loaded, x, "silu")
    b = jax_apply(yolo["jmq"], yolo["qvars"], x, "silu")
    np.testing.assert_array_equal(a["cls_logits"], b["cls_logits"])
