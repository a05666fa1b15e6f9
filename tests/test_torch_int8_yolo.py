"""The int8 YOLO family of the port against JAX's on the CPU: each block's
int8 branch on JAX's own input codes (``ConvBNAct``, ``Bottleneck``,
``CSPStage``, ``SPPF``, ``SpaceToDepthStem``, ``PlainStage``, ``upsample2x``,
``QPredConv``), YOLO-n and MoE-YOLO-n int8 detectors on JAX's quant tree in
the ``silu`` and ``bf16`` epilogues (and YOLO-n's ``fp_box``), the NMS tail on
JAX's int8 outputs, the w8a8 expert sweep, and ``loading.quantize_loaded`` on
a port run dir. The JAX side runs as ``tests/test_quant.py`` runs it: variant
``"n"``, 64×96."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_int8 import (
    EPILOGUES,
    assert_closer,
    assert_codes_close,
    calib_images,
    epilogue,
    jax_apply,
    jax_quantize,
    nhwc_codes,
    port_apply,
    port_qt,
    trees_equal,
    two_threads,  # noqa: F401  (autouse)
)
from _torch_parity import numpy_variables
from multimodal_moe_torch import loading as tload
from multimodal_moe_torch import quant as tq
from multimodal_moe_torch import serving as tserving
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.models import layers as tl
from multimodal_moe_torch.models import moe as tmoe
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector as TorchMoEYolo
from multimodal_moe_torch.models.yolo import QPredConv as TorchQPredConv
from multimodal_moe_torch.models.yolo import YoloDetector as TorchYolo
from multimodal_moe_torch.ops.int8_conv import int8_conv2d
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.train.evaluator import make_inference_fn
from multimodal_moe_torch.train.state import CheckpointManager
from multimodal_moe_tpu import quant as jq
from multimodal_moe_tpu import serving as jserving
from multimodal_moe_tpu.models import layers as jl
from multimodal_moe_tpu.models import moe as jmoe
from multimodal_moe_tpu.models.moe_yolo import MoEYoloDetector as JaxMoEYolo
from multimodal_moe_tpu.models.yolo import QPredConv as JaxQPredConv
from multimodal_moe_tpu.models.yolo import YoloDetector as JaxYolo

H, W = 64, 96
# Share of output codes allowed one apart from JAX's in a block: 0 seen on
# this CPU in every case below (the epilogue reproduces XLA's roundings);
# the allowance covers an exp/sigmoid one ulp apart on another libm.
BLOCK_SHARE = 1e-3

# (name, JAX block, port block, NHWC input shape)
BLOCKS = [
    ("convbnact", lambda: jl.ConvBNAct(16, 3), lambda: tl.ConvBNAct(8, 16, 3, int8=True),
     (2, 10, 12, 8)),
    ("convbnact_s2", lambda: jl.ConvBNAct(16, 3, strides=2),
     lambda: tl.ConvBNAct(8, 16, 3, strides=2, int8=True), (2, 10, 12, 8)),
    ("bottleneck", lambda: jl.Bottleneck(8), lambda: tl.Bottleneck(8, 8, int8=True),
     (2, 10, 12, 8)),
    ("csp", lambda: jl.CSPStage(16, num_blocks=2),
     lambda: tl.CSPStage(8, 16, 2, int8=True), (2, 10, 12, 8)),
    ("sppf", lambda: jl.SPPF(16), lambda: tl.SPPF(8, 16, int8=True), (2, 10, 12, 8)),
    ("stem", lambda: jl.SpaceToDepthStem(16), lambda: tl.SpaceToDepthStem(3, 16, int8=True),
     (2, 16, 24, 3)),
    ("plain", lambda: jl.PlainStage(8, num_blocks=2),
     lambda: tl.PlainStage(8, 8, 2, int8=True), (2, 10, 12, 8)),
    ("plain_reduce", lambda: jl.PlainStage(8, num_blocks=2, shortcut=True),
     lambda: tl.PlainStage(16, 8, 2, int8=True), (2, 10, 12, 16)),
]


def _block_case(jblock, shape, seed):
    """JAX's quantization of ``jblock`` on a random input: (variables,
    quant variables, input QT)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    if shape[-1] == 3:
        x = rng.random(shape).astype(np.float32)
    variables = numpy_variables(jblock, jnp.zeros(shape), seed=seed)
    qcal = jq.calibrate(jblock, variables, [x])
    s_in = jnp.float32(np.abs(x).max() / 127)
    x_q = jq.QT(jq.quantize_to(jnp.asarray(x), s_in), s_in)
    qvars = jax.device_get(jq.build_quant_variables(jblock, variables, qcal, x_q))
    return qvars, x_q


@pytest.mark.parametrize("mode", EPILOGUES)
@pytest.mark.parametrize("name,jmake,tmake,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_on_jax_codes(name, jmake, tmake, shape, mode):
    jblock = jmake()
    qvars, x_q = _block_case(jblock, shape, seed=len(name))
    ref = jax_apply(jblock, qvars, x_q, mode)
    tblock = tq.load_serving(tmake(), qvars).eval()
    x_t = port_qt(np.asarray(x_q.q), x_q.s)
    got = port_apply(tblock, x_t, mode)
    assert float(got.s) == float(ref.s)
    assert_codes_close(torch.from_numpy(nhwc_codes(got)), ref.q, BLOCK_SHARE)
    if name.startswith("convbnact"):
        # the int32 accumulator of the block's conv, bit for bit
        stride = 2 if name.endswith("s2") else 1
        acc = lax.conv_general_dilated(
            x_q.q, jnp.asarray(qvars["quant"]["w_q"]), (stride, stride), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        mine = int8_conv2d(x_t.q, tblock.w_q, stride, 1)
        np.testing.assert_array_equal(mine.permute(0, 2, 3, 1).numpy(), np.asarray(acc))


def test_upsample_and_qpredconv_on_jax_codes():
    rng = np.random.default_rng(8)
    q = rng.integers(-127, 128, (2, 5, 7, 16)).astype(np.int8)
    s = np.float32(0.03)
    ref = jl.upsample2x(jq.QT(jnp.asarray(q), jnp.asarray(s)))
    got = tl.upsample2x(port_qt(q, s))
    np.testing.assert_array_equal(nhwc_codes(got), np.asarray(ref.q))
    # the 1x1 prediction conv: fp32 out, from the folded plain conv
    pnode = {"kernel": rng.normal(0, 0.2, (1, 1, 16, 5)).astype(np.float32),
             "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    qvars = {"quant": jax.device_get(jq._fold_predconv(pnode))}
    jref = np.asarray(JaxQPredConv(5).apply(qvars, jq.QT(jnp.asarray(q), jnp.asarray(s))))
    tpred = tq.load_serving(TorchQPredConv(16, 5), qvars)
    with torch.inference_mode():
        mine = tpred(port_qt(q, s)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(mine, jref)


# --------------------------------------------------------------------------
# YOLO-n int8
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo():
    jm = JaxYolo(num_classes=1, variant="n")
    jmq = JaxYolo(num_classes=1, variant="n", int8=True)
    variables = numpy_variables(jm, jnp.zeros((1, H, W, 3)), train=False, seed=11)
    images = calib_images(3, H, W, seed=12)
    qcal, qvars = jax_quantize(jm, jmq, variables, images)
    x = jnp.asarray(images[0])
    fp_out = jax_apply(jm, variables, x, "silu")
    fp = TorchYolo(num_classes=1, variant="n")
    fp.load_state_dict(flax_to_state_dict(variables), strict=True)
    return dict(jm=jm, jmq=jmq, variables=variables, images=images, qcal=qcal, qvars=qvars,
                fp_out=fp_out, fp=fp.eval())


@pytest.mark.parametrize("mode", EPILOGUES)
def test_yolo_int8_matches_jax(yolo, mode):
    tree = tq.build_quant_variables(TorchYolo(num_classes=1, variant="n", int8=True),
                                    yolo["fp"].state_dict(), yolo["qcal"])
    trees_equal(tree, yolo["qvars"])
    model = tq.load_serving(TorchYolo(num_classes=1, variant="n", int8=True), tree).eval()
    ref = jax_apply(yolo["jmq"], yolo["qvars"], jnp.asarray(yolo["images"][0]), mode)
    got = port_apply(model, torch.from_numpy(yolo["images"][0]), mode)
    assert_closer(got, ref, yolo["fp_out"])
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"], rtol=0, atol=5e-3)
    assert all(got[k].dtype == torch.float32 for k in ("box_logits", "cls_logits", "boxes"))


def test_yolo_int8_fp_box_matches_jax(yolo):
    """The fp box branch reads the fp weights beside the int8 trunk."""
    jmb = JaxYolo(num_classes=1, variant="n", int8=True, int8_fp_box=True)
    serving = jq.merge_serving_variables(yolo["qvars"], yolo["variables"])
    ref = jax_apply(jmb, serving, jnp.asarray(yolo["images"][0]), "bf16")
    model = TorchYolo(num_classes=1, variant="n", int8=True, int8_fp_box=True)
    tq.load_serving(model, tq.merge_serving_variables(yolo["qvars"], yolo["fp"].state_dict()))
    assert torch.equal(model.head.box0_conv1.conv.weight, yolo["fp"].head.box0_conv1.conv.weight)
    assert isinstance(model.head.box2_pred, torch.nn.Conv2d)
    got = port_apply(model.eval(), torch.from_numpy(yolo["images"][0]), "bf16")
    assert_closer(got, ref, yolo["fp_out"])


def test_nms_tail_on_jax_int8_outputs(yolo):
    """The port's tail on JAX's own int8 outputs gives JAX's NmsResult bit
    for bit; the port's own serving step runs on the int8 model, which holds
    buffers only."""
    kw = dict(iou_threshold=0.7, score_threshold=0.001, max_det=20)
    images_u8 = np.random.default_rng(13).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    with epilogue("bf16"):
        jres = jax.device_get(jserving.make_serving_step(yolo["jmq"], pool=32, **kw)(
            yolo["qvars"], jnp.asarray(images_u8)))
    out = jax_apply(yolo["jmq"], yolo["qvars"], jnp.asarray(images_u8, jnp.float32) / 255.0, "bf16")
    scores = torch.sigmoid(torch.from_numpy(np.asarray(out["cls_logits"]))[..., 0])
    got = tserving.batched_nms(torch.from_numpy(np.asarray(out["boxes"])), scores,
                               num_candidates=32, **kw)
    assert bool(got.valid.any())
    for a, b in zip(got, jres):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = tq.load_serving(TorchYolo(num_classes=1, variant="n", int8=True), yolo["qvars"]).eval()
    assert not list(model.parameters())
    with epilogue("bf16"):
        res = tserving.make_serving_step(model, pool=32, **kw)(images_u8)
    assert res.boxes.shape == (2, 20, 4)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))


# --------------------------------------------------------------------------
# MoE-YOLO-n int8 and the w8a8 sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe():
    """E = 2, k = 2: every token goes to both experts, so the routing has no
    discrete choice to disagree on; solar bins as context."""
    kw = dict(num_classes=1, variant="n", num_experts=2, dispatch="sweep")
    jm, jmq = JaxMoEYolo(**kw), JaxMoEYolo(**kw, int8=True)
    ctx = np.array([1, 4], np.int32)
    variables = numpy_variables(jm, jnp.zeros((1, H, W, 3)), train=False, seed=14)
    images = calib_images(2, H, W, seed=15)
    qcal, qvars = jax_quantize(jm, jmq, variables, images, context_ids=jnp.asarray(ctx))
    serving = jq.merge_serving_variables(qvars, variables)
    fp = TorchMoEYolo(**kw)
    fp.load_state_dict(flax_to_state_dict(variables), strict=True)
    return dict(kw=kw, jm=jm, jmq=jmq, variables=variables, images=images, qcal=qcal,
                qvars=qvars, serving=serving, ctx=ctx, fp=fp.eval())


@pytest.mark.parametrize("mode", EPILOGUES)
def test_moe_yolo_int8_matches_jax(moe, mode):
    q = TorchMoEYolo(**moe["kw"], int8=True)
    tree = tq.build_quant_variables(q, moe["fp"].state_dict(), moe["qcal"])
    trees_equal(tree, moe["qvars"])
    for i in range(3):
        assert float(q.get_buffer(f"s_moe_out_{i}")) == 1.0   # until loaded
    tq.load_serving(q, tq.merge_serving_variables(tree, moe["fp"].state_dict()))
    x = jnp.asarray(moe["images"][0])
    ctx = jnp.asarray(moe["ctx"])
    ref = jax_apply(moe["jmq"], moe["serving"], x, mode, context_ids=ctx)
    fp_ref = jax_apply(moe["jm"], moe["variables"], x, "silu", context_ids=ctx)
    got = port_apply(q.eval(), torch.from_numpy(moe["images"][0]), mode,
                     context_ids=torch.from_numpy(moe["ctx"]).long())
    assert_closer(got, ref, fp_ref)
    np.testing.assert_allclose(got["expert_load"].numpy(), ref["expert_load"], atol=1e-6)


def test_moe_calibration_matches_jax(moe):
    got = tq.calibrate(moe["fp"], moe["images"], context_ids=torch.from_numpy(moe["ctx"]).long())
    fr, fg = tq.flatten(moe["qcal"]), tq.flatten(got)
    assert set(fr) == set(fg) and "moe_level0/mid_absmax" in fg
    for k in fr:
        np.testing.assert_allclose(fg[k], fr[k], rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("mode", EPILOGUES)
def test_sweep_int8_matches_jax(mode, monkeypatch):
    """``moe_apply_sweep_int8`` at E = 4, k = 2 against JAX's: the same
    experts, gates and int32 products; fp32 out within float32 summation
    order. Token chunks change nothing."""
    rng = np.random.default_rng(16)
    t, d, h, e = 300, 16, 32, 4
    args = dict(
        tokens_q=rng.integers(-127, 128, (t, d)).astype(np.int8),
        token_scale=np.float32(0.02),
        expert_idx=np.stack([rng.permutation(e)[:2] for _ in range(t)]).astype(np.int32),
        gates=rng.dirichlet([1, 1], t).astype(np.float32),
        w1_q=rng.integers(-127, 128, (e, d, h)).astype(np.int8),
        s_w1=rng.uniform(1e-3, 3e-3, (e, h)).astype(np.float32),
        b1=rng.normal(0, 0.1, (e, 1, h)).astype(np.float32),
        s_mid=rng.uniform(0.02, 0.05, e).astype(np.float32),
        w2_q=rng.integers(-127, 128, (e, h, d)).astype(np.int8),
        s_w2=rng.uniform(1e-3, 3e-3, (e, d)).astype(np.float32),
        b2=rng.normal(0, 0.1, (e, 1, d)).astype(np.float32),
    )
    with epilogue(mode):
        # a fresh function to trace: jax.jit caches by function, not by mode
        ref = np.asarray(jax.jit(lambda **a: jmoe.moe_apply_sweep_int8(**a))(**args))
        targs = {k: torch.from_numpy(np.asarray(v)) for k, v in args.items()}
        targs["expert_idx"] = targs["expert_idx"].long()
        got = tmoe.moe_apply_sweep_int8(**targs).numpy()
        monkeypatch.setattr(tmoe, "SWEEP_INT8_BUDGET_BYTES", 4 * h * 7)
        chunked = tmoe.moe_apply_sweep_int8(**targs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(chunked, got)


# --------------------------------------------------------------------------
# quantize_loaded on a port run dir
# --------------------------------------------------------------------------

def _run_dir(tmp_path, cfg):
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_config.json").write_text(json.dumps(cfg))
    torch.manual_seed(17)
    _, template = tload.build_detector(cfg)
    trainer = DetectionTrainer(template, DetTrainConfig(variant="n", img_h=H, img_w=W),
                               steps_per_epoch=1, device="cpu")
    CheckpointManager(run / "weights").save_best(trainer.init_state())
    return run


@pytest.mark.parametrize("family", ["yolo", "moe"])
def test_quantize_loaded_writes_then_reuses_the_npz(tmp_path, monkeypatch, family):
    cfg = {"family": family, "variant": "n"} | ({"num_experts": 2} if family == "moe" else {})
    run = _run_dir(tmp_path, cfg)
    loaded = tload.load_detector(run, img_h=H, img_w=W, device="cpu")
    batches = calib_images(2, H, W, seed=18)
    first = tload.quantize_loaded(loaded, batches)
    npz = run / "weights" / "int8_quant_best.npz"
    assert npz.exists() and first.family == family and not first.model.training
    assert first.model.int8 and set(first.variables) == set(first.model.state_dict())
    tree = tq.build_quant_variables(first.model, loaded.variables,
                                    tq.calibrate(loaded.model, batches))
    trees_equal(tq.load_quant_npz(npz), tree)

    def no_calibration(*a, **k):
        raise AssertionError("the npz beside the checkpoint should have been reused")

    monkeypatch.setattr(tq, "calibrate", no_calibration)
    again = tload.quantize_loaded(loaded, [])
    images = np.random.default_rng(19).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    a = make_inference_fn(first.model, first.variables)(images)
    b = make_inference_fn(again.model, again.variables)(images)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    boxed = tload.quantize_loaded(loaded, [], fp_box=True)
    head = boxed.model.head
    assert torch.equal(head.box1_conv2.conv.weight, loaded.variables["head.box1_conv2.conv.weight"])
    assert torch.equal(head.cls1_conv2.w_q, first.model.head.cls1_conv2.w_q)
    if family == "moe":
        router = "moe_level0.router.router_kernel"
        assert torch.equal(first.variables[router], loaded.variables[router])
