"""The port's training pieces against JAX on the CPU: augmentation, the
learning-rate schedule, clipping, the weight-decay mask, SGD-Nesterov and
AdamW with the EMA, and ``fit``: checkpoints, the crash-safe swap and
``restore_eval`` on a tiny RT-DETR; resume, the refusal to resume without
``last`` and early stop on a toy model (the epoch loop does not depend on
the detector). Three trainer steps against the JAX
trainer: tests/test_torch_train_step.py.

Random numbers: ``jax.random`` and ``torch.Generator`` differ, so JAX's
augmentation draws are recomputed from its key and fed to the port.

Tolerances (float32): augmentation atol 1e-6 (HSV round trips in other
op orders), flips and boxes exact; schedule values exact (both in
float32); the optimizers and the EMA after 3 steps on fed gradients
rtol 1e-6 / atol 1e-7.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from _torch_parity import as_torch, detection_batches, jax_augment_draws
from multimodal_moe_torch.convert import _param, flax_to_state_dict
from multimodal_moe_torch.models import rtdetr as tr
from multimodal_moe_torch.models.layers import FlaxBatchNorm2d
from multimodal_moe_torch.models.moe import MoEFFN as TorchMoEFFN
from multimodal_moe_torch.ops import augment as ta
from multimodal_moe_torch.train import detection as td
from multimodal_moe_torch.train import state as ts
from multimodal_moe_tpu.models import rtdetr as jr
from multimodal_moe_tpu.models.moe import MoEFFN as JaxMoEFFN
from multimodal_moe_tpu.ops import augment as jaug
from multimodal_moe_tpu.train import state as js

H, W = 64, 128


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------

def test_hsv_round_trip_matches_jax():
    rgb = np.random.default_rng(0).uniform(0, 1, (4, 9, 11, 3)).astype(np.float32)
    rgb[0, 0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 0, 0], [0.2, 0.9, 0.9]]  # grey, black, ties
    hsv = ta.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jaug.rgb_to_hsv(rgb)), atol=1e-6, rtol=0)
    back = ta.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(back, np.asarray(jaug.hsv_to_rgb(hsv)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(back, rgb, atol=1e-5)


@pytest.mark.parametrize("seed", [1, 2])
def test_train_augment_matches_jax_for_fed_draws(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (6, 8, 10, 3)).astype(np.float32)
    boxes = rng.uniform(0, 9, (6, 5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_boxes = jaug.train_augment(jnp.asarray(images), jnp.asarray(boxes), key)
    draws = jax_augment_draws(key, 6)
    assert np.asarray(draws["flip"]).any() and not np.asarray(draws["flip"]).all()
    got_img, got_boxes = ta.train_augment(torch.from_numpy(images), torch.from_numpy(boxes),
                                          draws=as_torch(draws))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(ref_boxes))


def test_hflip_mirrors_boxes_by_w_minus_one():
    img = torch.arange(2 * 1 * 4 * 3, dtype=torch.float32).reshape(2, 1, 4, 3)
    boxes = torch.tensor([[[0.0, 1.0, 1.0, 2.0]], [[0.0, 1.0, 1.0, 2.0]]])
    out_img, out_boxes = ta.random_hflip(img, boxes, torch.tensor([True, False]))
    assert torch.equal(out_img[0], img[0].flip(1)) and torch.equal(out_img[1], img[1])
    assert out_boxes[0].tolist() == [[2.0, 1.0, 3.0, 2.0]]      # (w − 1) − x with w = 4
    assert torch.equal(out_boxes[1], boxes[1])


def test_augment_draws_from_a_generator():
    a = ta.augment_draws(5, torch.Generator().manual_seed(0), torch.device("cpu"))
    b = ta.augment_draws(5, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (a["dh"].abs() <= 0.015).all() and ((a["gs"] - 1).abs() <= 0.7).all()
    assert a["flip"].dtype == torch.bool


# --------------------------------------------------------------------------
# schedule, clip, decay mask, optimizers, EMA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lrf,warmup,total", [(0.01, 5, 20), (1.0, 3, 10), (0.1, 1, 1)])
def test_schedule_matches_optax(lrf, warmup, total):
    warmup_c = max(1, min(warmup, max(total - 1, 1)))
    ref = optax.join_schedules([optax.linear_schedule(0.0, 0.02, warmup_c),
                                optax.linear_schedule(0.02, 0.02 * lrf, max(total - warmup_c, 1))],
                               [warmup_c])
    got = ts.make_schedule(0.02, lrf, warmup_c, total)
    assert got(0) == 0.0
    for step in range(total + 3):
        assert got(step) == float(ref(step)), step


class _Tiny(nn.Module):
    """Flax names: a conv kernel, a Dense kernel, a LayerNorm, a raw
    ``*kernel`` and a raw non-kernel parameter."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 4, 3, bias=False)
        self.Dense_0 = nn.Linear(4, 5)
        self.LayerNorm_0 = nn.LayerNorm(5)
        self.router_kernel = nn.Parameter(torch.zeros(5, 2))
        self.experts_w1 = nn.Parameter(torch.zeros(2, 5, 3))


def _tiny_flax_params(seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return {"Conv_0": {"kernel": n(3, 3, 3, 4)}, "Dense_0": {"kernel": n(4, 5), "bias": n(5)},
            "LayerNorm_0": {"scale": n(5), "bias": n(5)}, "router_kernel": n(5, 2),
            "experts_w1": n(2, 5, 3)}


def _mask_by_torch_name(mask, shapes):
    """A Flax tree of booleans → {torch key: bool}, keyed as
    ``flax_to_state_dict`` keys the parameters of ``shapes``."""
    out = {}

    def walk(m, s, path):
        for k, v in m.items():
            if isinstance(v, dict):
                walk(v, s[k], path + (k,))
            else:
                key, _ = _param(path + (k,), np.zeros(s[k].shape, np.float32))
                out[key] = bool(v)
    walk(mask, shapes, ())
    return out


def test_decay_mask_matches_jax():
    """RT-DETR's and the MoE layer's trees: decayed are Dense, conv and
    attention kernels and ``router_kernel``; not decayed are biases, norm
    scales, ``dn_content_embed``, ``experts_w1``."""
    cases = [
        (jr.RTDETRDetector(**dict(num_classes=1, hidden_dim=32, num_queries=4,
                                  num_decoder_layers=1, num_heads=2,
                                  backbone_depths=(1, 1, 1, 1))),
         (jnp.zeros((1, H, W, 3)),),
         tr.RTDETRDetector(num_classes=1, hidden_dim=32, num_queries=4, num_decoder_layers=1,
                           num_heads=2, backbone_depths=(1, 1, 1, 1))),
        (JaxMoEFFN(num_experts=4), (jnp.zeros((6, 16)), jnp.zeros((6,), jnp.int32)),
         TorchMoEFFN(16, num_experts=4)),
    ]
    for jmod, args, tmod in cases:
        shapes = jax.eval_shape(lambda r: jmod.init(r, *args), jax.random.PRNGKey(0))["params"]
        ref = _mask_by_torch_name(js._decay_mask(shapes), shapes)
        got = ts.decay_mask(tmod)
        assert set(got) == set(ref)
        assert {k for k, v in got.items() if v} == {k for k, v in ref.items() if v}
    got = ts.decay_mask(tr.RTDETRDetector(num_classes=1, hidden_dim=32, num_queries=4,
                                          num_decoder_layers=1, num_heads=2,
                                          backbone_depths=(1, 1, 1, 1)))
    assert got["decoder0.self_attn.query.weight"] and got["backbone._ConvBN_0.Conv_0.weight"]
    assert not got["dn_content_embed"] and not got["decoder0.LayerNorm_0.weight"]
    assert not got["backbone._ConvBN_0.BatchNorm_0.weight"]


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_optimizer_and_ema_match_optax(optimizer):
    """3 steps on fed gradients (the 2nd above the clip norm) with a warmup
    of 2: optax's chain and ``TrainState.apply_gradients`` (with the EMA)
    against the port's."""
    kw = dict(lr0=0.05, lrf=0.1, momentum=0.9, weight_decay=0.01, warmup_steps=2,
              total_steps=6, optimizer=optimizer)
    params = _tiny_flax_params(0)
    tx = js.make_optimizer(**kw)
    jstate = js.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                           opt_state=tx.init(params), ema_params=jax.tree.map(jnp.copy, params))
    model = _Tiny()
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in _flax_to_torch_names_layout(params).items()})
    tstate = ts.make_train_state(model, **kw)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.normal(0, 30.0 if step == 1 else 0.5, p.shape)
                                        .astype(np.float32)), params)
        assert (float(optax.global_norm(grads)) > 10) == (step == 1)
        jstate = jstate.apply_gradients(grads, tx, {})
        tstate.apply_gradients({k: torch.from_numpy(v.copy())
                                for k, v in _flax_to_torch_names_layout(grads).items()})
    assert tstate.step == int(jstate.step) == 3
    for name, tree in (("params", jstate.params), ("ema", jstate.ema_params)):
        ref = _flax_to_torch_names_layout(jax.device_get(tree))
        got = tstate.params if name == "params" else tstate.ema_params
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{optimizer} {name} {k}")
    moved = _flax_to_torch_names_layout(params)
    assert any(not np.allclose(tstate.params[k].detach().numpy(), v) for k, v in moved.items())


def _flax_to_torch_names_layout(tree):
    """Flax leaves → {torch key: array in the torch layout}."""
    return {k: v.numpy() for k, v in flax_to_state_dict({"params": jax.device_get(tree)}).items()}


def test_clip_has_no_epsilon():
    """``(g / ‖g‖)·max_norm`` exactly where ‖g‖ ≥ max_norm; untouched below."""
    p = {"w": torch.zeros(3)}
    opt = ts.Optimizer(p, {"w": False}, lr0=1.0, lrf=1.0, warmup_steps=1, total_steps=3,
                       optimizer="sgd", momentum=0.0, weight_decay=0.0)
    opt.step({"w": torch.tensor([3.0, 4.0, 0.0])})   # lr 0 at count 0
    opt.step({"w": torch.tensor([30.0, 40.0, 0.0])})  # norm 50 → 10
    assert p["w"].tolist() == [-6.0, -8.0, 0.0]


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------

FIT_MODEL = dict(num_classes=1, hidden_dim=32, num_queries=8, num_decoder_layers=1, num_heads=2,
                 backbone_depths=(1, 1, 1, 1))


class _ToyDetector(nn.Module):
    """The trainer's model contract at the smallest size (NHWC images in, a
    BatchNorm with running statistics, a dict out), for the tests of the
    epoch loop, which does not depend on the detector."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 4, 3, padding=1)
        self.BatchNorm_0 = FlaxBatchNorm2d(4)
        self.Dense_0 = nn.Linear(4, 4)

    def forward(self, images, train=False):
        x = self.BatchNorm_0(self.Conv_0(images.permute(0, 3, 1, 2)))
        return {"pred_boxes": torch.sigmoid(self.Dense_0(x.mean((2, 3))))}


def _toy_loss(outputs, gt_labels, gt_boxes, gt_mask):
    loss = ((outputs["pred_boxes"] - gt_boxes[:, 0] / W) ** 2).mean()
    return loss, {"loss": loss}


def _fit_trainer(toy=True, **cfg):
    """A trainer on the CPU: the toy model, or the tiny RT-DETR with its loss."""
    if toy:
        model, loss_fn = _ToyDetector(), _toy_loss
    else:
        model = tr.RTDETRDetector(**FIT_MODEL, generator=torch.Generator().manual_seed(0))
        loss_fn = functools.partial(tr.rtdetr_loss, img_hw=(H, W))
    cfg = td.DetTrainConfig(**{**dict(variant="r50vd", img_h=H, img_w=W, epochs=2, batch=2,
                                      lr0=1e-4, lrf=1.0, optimizer="adamw", weight_decay=1e-4,
                                      warmup_epochs=0.0, patience=10), **cfg})
    return td.DetectionTrainer(model, cfg, loss_fn=loss_fn, device=torch.device("cpu"))


LOADER = detection_batches(1, H, W, seed=7)      # one step per epoch


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("det_run")
    trainer = _fit_trainer(toy=False)
    state, summary = trainer.fit(LOADER, run_dir=run_dir, log_every=1)
    return trainer, state, summary, run_dir


def test_fit_runs_and_writes_checkpoints(trained):
    trainer, state, summary, run_dir = trained
    assert summary["epochs_run"] == 2 and summary["completed"]
    assert state.step == 2 and np.isfinite(summary["history"][0]["loss"])
    assert {"loss", "cls_loss", "box_loss", "giou_loss", "num_fg", "dn_loss", "epoch"} <= set(
        summary["history"][0])
    for name in ("last", "best"):
        assert (run_dir / "weights" / name / "state.pt").exists()
    prog = json.loads((run_dir / "fit_progress.json").read_text())
    assert set(prog) == {"epoch", "best_fitness", "epochs_without_improvement",
                         "train_wall_s_accum", "history"}
    assert prog["epoch"] == 1
    init = trainer.init_state()
    assert any(not torch.equal(a, b) for a, b in zip(init.params.values(),
                                                     state.params.values()))


def test_save_swap_recovers_interrupted_rename(trained):
    trainer, state, _, run_dir = trained
    ckpt = ts.CheckpointManager(run_dir / "weights")
    (run_dir / "weights" / "last").rename(run_dir / "weights" / "last.new")
    assert ckpt.has("last")
    assert (run_dir / "weights" / "last").exists()
    restored = ckpt.restore("last", trainer.init_state())
    assert restored.step == state.step
    for k, p in restored.params.items():
        assert torch.equal(p, state.params[k]), k
    for k, v in restored.opt.state["mu"].items():
        assert torch.equal(v, state.opt.state["mu"][k]), k


def test_restore_eval_ignores_the_optimizer(trained):
    """An AdamW checkpoint restores into an SGD-built state."""
    _, state, _, run_dir = trained
    sgd = _fit_trainer(toy=False, optimizer="sgd").init_state()
    with pytest.raises(ValueError, match="optimizer state"):
        ts.CheckpointManager(run_dir / "weights").restore("best", sgd)
    restored = ts.CheckpointManager(run_dir / "weights").restore_eval("best", sgd)
    assert restored.opt.state["count"] == 0
    best = torch.load(run_dir / "weights" / "best" / "state.pt", weights_only=True)
    for k, v in restored.ema_params.items():
        assert torch.equal(v, best["ema_params"][k]), k


def test_fit_resume_continues_from_progress(tmp_path):
    trainer = _fit_trainer(epochs=4)
    _, s1 = trainer.fit(LOADER, run_dir=tmp_path, max_epochs_this_run=2)
    assert s1["epochs_run"] == 2 and not s1["completed"]
    state2, s2 = _fit_trainer(epochs=4).fit(LOADER, run_dir=tmp_path, resume=True)
    assert s2["epochs_run"] == 4 and s2["completed"]
    assert [r["epoch"] for r in s2["history"]] == [0, 1, 2, 3]
    assert state2.step == 4 and state2.opt.state["count"] == 4


def test_resume_refuses_when_checkpoint_lost(tmp_path):
    import shutil

    _fit_trainer(epochs=3).fit(LOADER, run_dir=tmp_path, max_epochs_this_run=1)
    shutil.rmtree(tmp_path / "weights" / "last")
    with pytest.raises(RuntimeError, match="weights/last is missing"):
        _fit_trainer(epochs=3).fit(LOADER, run_dir=tmp_path, resume=True)


def test_early_stop_after_patience(tmp_path):
    fitness = iter([0.5, 0.4, 0.3, 0.2, 0.1])
    _, summary = _fit_trainer(epochs=5, patience=1).fit(
        LOADER, run_dir=tmp_path, val_fn=lambda state: {"map50_95": next(fitness)})
    assert summary["stopped_early"] and summary["epochs_run"] == 3
    assert summary["best_fitness"] == pytest.approx(0.9 * 0.5)
    assert summary["history"][0]["val_map50_95"] == 0.5


def test_trainer_needs_a_loss_and_a_device():
    model = tr.RTDETRDetector(**FIT_MODEL)
    with pytest.raises(NotImplementedError, match="losses/tal.py"):
        td.DetectionTrainer(model, td.DetTrainConfig(), device=torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            td.DetectionTrainer(model, td.DetTrainConfig(), loss_fn=tr.rtdetr_loss)
