"""The port's ``loading.py`` (CPU): ``resolve_checkpoint`` against JAX's on
the same directory trees; ``build_detector``'s state_dict keys and shapes
against ``convert.flax_to_state_dict`` of JAX's ``build_detector`` model
for each family; ``load_detector`` restoring what ``CheckpointManager``
saved, with the EMA parameters and without."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_variables
from multimodal_moe_torch import loading as tload
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.serving import topk_candidates
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.train.evaluator import make_inference_fn
from multimodal_moe_torch.train.state import CheckpointManager
from multimodal_moe_tpu import loading as jload

H, W = 64, 128


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tree(tmp_path, with_config=True):
    run = tmp_path / "run"
    for which in ("best", "last"):
        (run / "weights" / which).mkdir(parents=True)
    if with_config:
        (run / "model_config.json").write_text(json.dumps({"family": "moe", "variant": "n"}))
    return run


@pytest.mark.parametrize("with_config", [True, False])
@pytest.mark.parametrize("which", ["best", "last", "missing"])
def test_resolve_checkpoint_matches_jax(tmp_path, with_config, which):
    run = _tree(tmp_path, with_config)
    for probe in (run, run / "weights", run / "weights" / "best", run / "weights" / "last",
                  tmp_path):
        assert tload.resolve_checkpoint(probe, which) == jload.resolve_checkpoint(probe, which)
    if with_config:
        path, cfg = tload.resolve_checkpoint(run, "best")
        assert path == run / "weights" / "best" and cfg["family"] == "moe"


def _shapes(state_dict):
    return {k: tuple(v.shape) for k, v in state_dict.items()}


@pytest.mark.parametrize("cfg", [
    {"family": "yolo", "variant": "n"},
    {"variant": "n", "num_classes": 2},
    {"family": "moe", "variant": "n", "num_experts": 3},
    {"family": "rtdetr", "hidden_dim": 64, "num_queries": 20, "num_decoder_layers": 2},
], ids=["yolo", "default-family", "moe", "rtdetr"])
def test_build_detector_matches_jax_layout(cfg):
    family, model = tload.build_detector(cfg)
    jfamily, jmodel = jload.build_detector(cfg)
    assert family == jfamily
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)))
    ref = _shapes(flax_to_state_dict(variables))
    got = _shapes(model.state_dict())
    assert got == ref
    for key in ("num_classes", "num_experts", "hidden_dim", "num_queries",
                "num_decoder_layers"):
        if hasattr(jmodel, key) and hasattr(model, key):
            assert getattr(model, key) == getattr(jmodel, key), key


def test_build_detector_int8_waits_for_a3():
    """Since A3 (int8 serving) came, ``int8`` builds the int8 model and
    ``int8, fp_box`` its fp-box twin, as JAX's ``build_detector`` does;
    ``fp_box`` alone leaves the fp model."""
    cfg = {"family": "yolo", "variant": "n"}
    _, fp = tload.build_detector(cfg, fp_box=True)
    assert not fp.int8 and isinstance(fp.head.box0_pred, torch.nn.Conv2d)
    _, q = tload.build_detector(cfg, int8=True)
    assert q.int8 and not list(q.parameters()) and q.head.box0_conv1.w_q.dtype == torch.int8
    _, qb = tload.build_detector(cfg, int8=True, fp_box=True)
    assert qb.int8 and isinstance(qb.head.box0_pred, torch.nn.Conv2d)
    assert qb.head.cls0_conv1.w_q.dtype == torch.int8
    _, jq = jload.build_detector(cfg, int8=True, fp_box=True)
    assert jq.int8 and jq.int8_fp_box


def _saved_run(tmp_path):
    """A YOLO-n run dir: model_config.json and weights/best and weights/last,
    with EMA parameters and running statistics that differ from the
    parameters and from a fresh init."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_config.json").write_text(json.dumps({"family": "yolo", "variant": "n"}))
    _, template = tload.build_detector({"family": "yolo", "variant": "n"})
    trainer = DetectionTrainer(template, DetTrainConfig(variant="n", img_h=H, img_w=W),
                               steps_per_epoch=1, device="cpu")
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in list(state.ema_params.values()) + list(state.batch_stats.values()):
            t.add_(0.01 * torch.randn(t.shape, generator=gen))
    ckpt = CheckpointManager(run / "weights")
    ckpt.save_best(state)
    with torch.no_grad():
        for p in state.params.values():
            p.mul_(0.5)
    ckpt.save_last(state)
    return run, state


@pytest.mark.parametrize("use_ema", [True, False])
@pytest.mark.parametrize("checkpoint", ["best", "last"])
def test_load_detector_round_trip(tmp_path, use_ema, checkpoint):
    run, state = _saved_run(tmp_path)
    raw = torch.load(run / "weights" / checkpoint / "state.pt", weights_only=True)
    loaded = tload.load_detector(run, checkpoint=checkpoint, img_h=H, img_w=W,
                                 use_ema=use_ema, device="cpu")
    assert loaded.family == "yolo" and loaded.model_cfg == {"family": "yolo", "variant": "n"}
    assert loaded.ckpt_path == (run / "weights" / checkpoint).resolve()
    assert not loaded.model.training
    expect = dict(raw["model"])
    if use_ema:
        expect.update(raw["ema_params"])
    assert set(loaded.variables) == set(expect)
    for k, v in expect.items():
        assert torch.equal(loaded.variables[k], v), k
        assert torch.equal(loaded.model.state_dict()[k], v), k
    # the model and its variables give the same detections
    images = np.random.default_rng(5).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    a = make_inference_fn(loaded.model, loaded.variables)(images)
    with torch.inference_mode():
        out = loaded.model(torch.from_numpy(images).float() / 255.0)
    b = topk_candidates(out, k=1024)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_load_detector_default_device_needs_cuda(tmp_path, monkeypatch):
    run, _ = _saved_run(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tload.load_detector(run)


def test_jax_and_port_share_the_config_keys(tmp_path):
    """The same model_config.json builds the same family and widths in both."""
    cfg = {"family": "moe", "variant": "n", "num_experts": 2, "optimizer": "adamw"}
    (tmp_path / "model_config.json").write_text(json.dumps(cfg))
    (tmp_path / "weights" / "best").mkdir(parents=True)
    t_path, t_cfg = tload.resolve_checkpoint(tmp_path / "weights" / "best")
    j_path, j_cfg = jload.resolve_checkpoint(tmp_path / "weights" / "best")
    assert (t_path, t_cfg) == (j_path, j_cfg) and t_cfg == cfg
    family, model = tload.build_detector(t_cfg)
    assert family == "moe" and model.moe_level0.num_experts == 2
