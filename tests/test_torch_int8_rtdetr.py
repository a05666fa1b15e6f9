"""The int8 RT-DETR of the port against JAX's on the CPU: the ResNet-vd
blocks' int8 branches on JAX's own input codes (``_ConvBN`` with the ReLU
epilogue and without, the -vd shortcut's average pool on the codes at odd
map sizes, a whole backbone with the stem's int8 max-pool), a tiny int8
RT-DETR (int8 backbone and CCFF, AIFI as a requantized fp island, fp
decoder) on JAX's quant tree in the ``silu`` and ``bf16`` epilogues, its
calibration, and ``loading.quantize_loaded`` on a port run dir. The JAX side
runs as ``tests/test_quant.py::test_rtdetr_int8_backbone_parity`` does."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_int8 import (
    EPILOGUES,
    assert_closer,
    assert_codes_close,
    calib_images,
    jax_apply,
    jax_quantize,
    nhwc_codes,
    port_apply,
    port_qt,
    trees_equal,
    two_threads,  # noqa: F401  (autouse)
)
from _torch_parity import numpy_variables, rtdetr_numpy_variables
from multimodal_moe_torch import loading as tload
from multimodal_moe_torch import quant as tq
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.models import resnet as tr
from multimodal_moe_torch.models.rtdetr import RTDETRDetector as TorchRTDETR
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.train.evaluator import make_inference_fn
from multimodal_moe_torch.train.state import CheckpointManager
from multimodal_moe_tpu import quant as jq
from multimodal_moe_tpu.models import resnet as jr
from multimodal_moe_tpu.models.rtdetr import RTDETRDetector as JaxRTDETR

H, W = 64, 96
BLOCK_SHARE = 1e-3   # as in test_torch_int8_yolo.py: 0 seen here

# (name, JAX block, port block, NHWC input shape); odd map sizes make the
# shortcut pool's "SAME" padding count a zero row and column
BLOCKS = [
    ("convbn_relu", lambda: jr._ConvBN(16, 3), lambda: tr._ConvBN(8, 16, 3, int8=True),
     (2, 9, 11, 8)),
    ("convbn_linear", lambda: jr._ConvBN(16, 1, act=False),
     lambda: tr._ConvBN(8, 16, 1, act=False, int8=True), (2, 9, 11, 8)),
    ("block_vd_s2", lambda: jr.BottleneckBlock(8, strides=2, vd=True),
     lambda: tr.BottleneckBlock(16, 8, 2, int8=True), (2, 9, 11, 16)),
    ("block_project", lambda: jr.BottleneckBlock(8, vd=True),
     lambda: tr.BottleneckBlock(16, 8, 1, int8=True), (2, 9, 11, 16)),
    ("block_identity", lambda: jr.BottleneckBlock(4, vd=True),
     lambda: tr.BottleneckBlock(16, 4, 1, int8=True), (2, 9, 11, 16)),
]


def _quantized(jmodule, x, seed):
    variables = numpy_variables(jmodule, jnp.zeros(x.shape), seed=seed)
    qcal = jq.calibrate(jmodule, variables, [x])
    s_in = jnp.float32(np.abs(x).max() / 127)
    x_q = jq.QT(jq.quantize_to(jnp.asarray(x), s_in), s_in)
    return jax.device_get(jq.build_quant_variables(jmodule, variables, qcal, x_q)), x_q


@pytest.mark.parametrize("mode", EPILOGUES)
@pytest.mark.parametrize("name,jmake,tmake,shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_resnet_block_on_jax_codes(name, jmake, tmake, shape, mode):
    x = np.abs(np.random.default_rng(len(name)).normal(0, 1, shape)).astype(np.float32)
    jblock = jmake()
    qvars, x_q = _quantized(jblock, x, seed=len(name))
    ref = jax_apply(jblock, qvars, x_q, mode)
    got = port_apply(tq.load_serving(tmake(), qvars).eval(), port_qt(np.asarray(x_q.q), x_q.s),
                     mode)
    assert float(got.s) == float(ref.s)
    assert_codes_close(torch.from_numpy(nhwc_codes(got)), ref.q, BLOCK_SHARE)


@pytest.mark.parametrize("mode", EPILOGUES)
def test_resnet_backbone_on_jax_codes(mode):
    """Deep stem, the stem's max-pool on the codes, four stages, at an odd
    input size."""
    jnet = jr.ResNet(stage_sizes=(1, 1, 1, 1), width=16, num_classes=None, vd=True)
    x = np.random.default_rng(21).random((2, 30, 46, 3)).astype(np.float32)
    qvars, _ = _quantized(jnet, x, seed=21)
    x_q = jq.q_from_images(jnp.asarray(x))
    ref = jax_apply(jnet, qvars, x_q, mode)
    tnet = tq.load_serving(tr.ResNet(stage_sizes=(1, 1, 1, 1), width=16, int8=True), qvars)
    got = port_apply(tnet.eval(), tq.q_from_images(torch.from_numpy(x)), mode)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert float(g.s) == float(r.s)
        assert_codes_close(torch.from_numpy(nhwc_codes(g)), r.q, BLOCK_SHARE)


@pytest.fixture(scope="module")
def rtdetr():
    kw = dict(num_classes=1, hidden_dim=32, num_queries=16, num_decoder_layers=1, num_heads=2,
              backbone_depths=(1, 1, 1, 1), num_denoising_groups=0)
    jm, jmq = JaxRTDETR(**kw), JaxRTDETR(**kw, int8=True)
    variables = rtdetr_numpy_variables(jm, H, W, seed=22)
    images = calib_images(2, H, W, seed=23)
    qcal, qvars = jax_quantize(jm, jmq, variables, images)
    fp = TorchRTDETR(**kw)
    fp.load_state_dict(flax_to_state_dict(variables), strict=True)
    fp_out = jax_apply(jm, variables, jnp.asarray(images[0]), "silu")
    return dict(kw=kw, jm=jm, jmq=jmq, variables=variables, images=images, qcal=qcal,
                qvars=qvars, fp=fp.eval(), fp_out=fp_out,
                serving=jq.merge_serving_variables(qvars, variables))


def test_rtdetr_build_and_calibrate_match_jax(rtdetr):
    """The ResNet fold (BN eps 1e-5), the CCFF fold (eps 1e-3) and
    ``s_aifi_0`` bit for bit from JAX's statistics; the port's own
    statistics within 1e-5 of JAX's."""
    q = TorchRTDETR(**rtdetr["kw"], int8=True)
    trees_equal(tq.build_quant_variables(q, rtdetr["fp"].state_dict(), rtdetr["qcal"]),
                rtdetr["qvars"])
    assert "s_aifi_0" in rtdetr["qvars"]["quant"]["encoder"]
    got = tq.flatten(tq.calibrate(rtdetr["fp"], rtdetr["images"]))
    ref = tq.flatten(rtdetr["qcal"])
    assert set(got) == set(ref) and "encoder/aifi0_absmax" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("mode", EPILOGUES)
def test_rtdetr_int8_matches_jax(rtdetr, mode):
    q = TorchRTDETR(**rtdetr["kw"], int8=True)
    tq.load_serving(q, tq.merge_serving_variables(rtdetr["qvars"], rtdetr["fp"].state_dict()))
    ref = jax_apply(rtdetr["jmq"], rtdetr["serving"], jnp.asarray(rtdetr["images"][0]), mode)
    got = port_apply(q.eval(), torch.from_numpy(rtdetr["images"][0]), mode)
    assert_closer(got, ref, rtdetr["fp_out"], keys=("pred_logits", "pred_boxes", "boxes"))
    assert got["boxes"].dtype == torch.float32


def test_quantize_loaded_rtdetr(tmp_path, monkeypatch):
    cfg = {"family": "rtdetr", "hidden_dim": 32, "num_queries": 16, "num_decoder_layers": 1}
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_config.json").write_text(json.dumps(cfg))
    torch.manual_seed(24)
    _, template = tload.build_detector(cfg)
    trainer = DetectionTrainer(template, DetTrainConfig(img_h=H, img_w=W), steps_per_epoch=1,
                               device="cpu")
    CheckpointManager(run / "weights").save_best(trainer.init_state())
    loaded = tload.load_detector(run, img_h=H, img_w=W, device="cpu")
    first = tload.quantize_loaded(loaded, calib_images(1, H, W, seed=25))
    assert (run / "weights" / "int8_quant_best.npz").exists()
    assert first.family == "rtdetr" and first.model.int8
    key = "decoder0.cross_attn.value_proj.weight"
    assert torch.equal(first.variables[key], loaded.variables[key])

    def no_calibration(*a, **k):
        raise AssertionError("the npz beside the checkpoint should have been reused")

    monkeypatch.setattr(tq, "calibrate", no_calibration)
    again = tload.quantize_loaded(loaded, [])
    images = np.random.default_rng(26).integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    a = make_inference_fn(first.model, first.variables)(images)
    b = make_inference_fn(again.model, again.variables)(images)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
