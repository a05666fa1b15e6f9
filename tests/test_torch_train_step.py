"""Three ``DetectionTrainer.train_step``s of a tiny RT-DETR, the port
against the JAX trainer on the CPU: the per-step losses, the parameters,
the EMA and the BatchNorm running statistics after the third step.

The tiny detector of tests/test_torch_rtdetr_train.py with one decoder
layer (B=2, 64×128, 3 ground-truth slots, one padded), AdamW at lr 1e-4
with a warmup of 2 steps (lr 0, 5e-5, 1e-4; ``scripts/train_rtdetr.py``'s
optimizer settings otherwise), HSV jitter and flips on. The JAX trainer
runs on a one-device mesh. Its draws (augmentation, denoising) and its
assignments are recorded with ``jax.debug.callback`` and fed to the port.

Tolerances (float32). Adam's first updates are lr·sign(g) elementwise
and later ones normalise by the gradient's history, so where a gradient
is near zero, or where successive gradients cancel, the 1e-2 relative
gradient differences of train-mode BatchNorm (tests/test_torch_rtdetr_train.py:
JAX's float32 trunk gradient is the inexact one) move an element by up to
a whole step the other way. So every parameter and EMA element is within
2·Σlr = 3e-4 of JAX's, each tensor's mean difference within 0.1·Σlr, and
at most 0.5 % of all elements differ by more than 0.1·Σlr. Running
statistics atol 2e-4; the per-step losses rtol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    as_torch,
    detection_batches,
    jax_augment_draws,
    jax_denoise_draws,
    load_flax,
    rtdetr_numpy_variables,
)
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.losses import hungarian as th
from multimodal_moe_torch.models import rtdetr as tr
from multimodal_moe_torch.train import detection as td
from multimodal_moe_tpu.models import rtdetr as jr
from multimodal_moe_tpu.ops import assignment as ja
from multimodal_moe_tpu.ops import augment as jaug
from multimodal_moe_tpu.train import state as js

H, W = 64, 128


TINY = dict(num_classes=1, hidden_dim=64, num_queries=20, num_decoder_layers=1, num_heads=4,
            backbone_depths=(1, 1, 1, 1))
CFG = dict(variant="r50vd", img_h=H, img_w=W, epochs=4, batch=2, lr0=1e-4, lrf=1.0,
           optimizer="adamw", weight_decay=1e-4, warmup_epochs=1.0)
SPE = 2          # steps per epoch: a warmup of 2 steps, lr 0, 5e-5, 1e-4
LR_SUM = 0.0 + 5e-5 + 1e-4


@pytest.fixture(scope="module")
def three_steps():
    from multimodal_moe_tpu.parallel.mesh import create_mesh, replicated
    from multimodal_moe_tpu.train.detection import DetectionTrainer as JaxTrainer
    from multimodal_moe_tpu.train.detection import DetTrainConfig as JaxConfig

    jmodel = jr.RTDETRDetector(**TINY)
    variables = rtdetr_numpy_variables(jmodel, H, W, seed=3)
    loss_kw = dict(img_hw=(H, W))
    jtrainer = JaxTrainer(jmodel, JaxConfig(**CFG), steps_per_epoch=SPE,
                          loss_fn=functools.partial(jr.rtdetr_loss, **loss_kw),
                          mesh=create_mesh(devices=jax.devices()[:1]))
    # init_state without its init compile: the same chain on numpy weights.
    jtrainer._tx = js.make_optimizer(lr0=CFG["lr0"], lrf=CFG["lrf"], momentum=0.937,
                                     weight_decay=CFG["weight_decay"], warmup_steps=SPE,
                                     total_steps=SPE * CFG["epochs"], optimizer="adamw")
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax.device_put(js.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer._tx.init(params), ema_params=jax.tree.map(jnp.copy, params)),
        replicated(jtrainer.mesh))

    rec = {"augment": [], "denoise": [], "assign": []}
    real = (jaug.train_augment, jr.build_denoising_queries, ja.batched_lsa_assign)

    def augment(images, boxes, rng, **kw):
        jax.debug.callback(lambda d: rec["augment"].append(jax.tree.map(np.asarray, d)),
                           jax_augment_draws(rng, images.shape[0]))
        return real[0](images, boxes, rng, **kw)

    def build(rng, gt_boxes, gt_mask, **kw):
        jax.debug.callback(lambda s, c: rec["denoise"].append((np.asarray(s), np.asarray(c))),
                           *jax_denoise_draws(rng, *gt_boxes.shape[:2]))
        return real[1](rng, gt_boxes, gt_mask, **kw)

    def assign(cost, col_valid=None):
        out = real[2](cost, col_valid)
        jax.debug.callback(lambda a: rec["assign"].append(np.asarray(a)), out)
        return out

    batches = detection_batches(3, H, W)
    jax_losses = []
    jaug.train_augment, jr.build_denoising_queries, ja.batched_lsa_assign = augment, build, assign
    try:
        for batch in batches:
            jstate, metrics = jtrainer.train_step(jstate, batch)
            jax_losses.append(float(metrics["loss"]))
        jax.effects_barrier()
    finally:
        jaug.train_augment, jr.build_denoising_queries, ja.batched_lsa_assign = real
    assert [len(v) for v in rec.values()] == [3, 3, 3]

    template = load_flax(tr.RTDETRDetector(**TINY), variables)
    trainer = td.DetectionTrainer(template, td.DetTrainConfig(**CFG), steps_per_epoch=SPE,
                                  loss_fn=functools.partial(tr.rtdetr_loss, **loss_kw),
                                  device=torch.device("cpu"))
    state = trainer.init_state()
    losses = []
    real_port = th.batched_lsa_assign
    try:
        for i, batch in enumerate(batches):
            th.batched_lsa_assign = lambda cost, col_valid=None, a=rec["assign"][i]: (
                torch.from_numpy(a.astype(np.int64)))
            draws = {"augment": as_torch(rec["augment"][i]), "denoise": as_torch(rec["denoise"][i])}
            state, metrics = trainer.train_step(state, trainer._to_device(batch), draws=draws)
            losses.append(float(metrics["loss"]))
    finally:
        th.batched_lsa_assign = real_port
    return dict(jstate=jax.device_get(jstate), jax_losses=jax_losses, state=state,
                losses=losses, variables=variables)


def test_trainer_losses_match_jax(three_steps):
    np.testing.assert_allclose(three_steps["losses"], three_steps["jax_losses"], rtol=1e-3)


def test_trainer_params_and_ema_match_jax(three_steps):
    state, jstate = three_steps["state"], three_steps["jstate"]
    assert state.step == int(jstate.step) == 3
    before = flax_to_state_dict({"params": three_steps["variables"]["params"]})
    far = count = 0
    for tree, got in ((jstate.params, state.params), (jstate.ema_params, state.ema_params)):
        ref = flax_to_state_dict({"params": tree})
        assert set(ref) == set(got)
        for k, v in ref.items():
            d = np.abs(got[k].detach().numpy() - v.numpy())
            assert d.max() <= 2 * LR_SUM + 1e-6, (k, float(d.max()))
            assert d.mean() <= 0.1 * LR_SUM, (k, float(d.mean()))
            far, count = far + int((d > 0.1 * LR_SUM).sum()), count + d.size
    assert far <= 0.005 * count, far / count
    moved = [k for k, p in state.params.items() if not torch.equal(p.detach(), before[k])]
    assert len(moved) > 0.9 * len(before)


def test_trainer_batch_stats_match_jax(three_steps):
    ref = flax_to_state_dict({"batch_stats": three_steps["jstate"].batch_stats})
    got = three_steps["state"].batch_stats
    assert len(got) > 50 and set(got) <= set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=2e-4, err_msg=k)
