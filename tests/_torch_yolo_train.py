"""Two ``DetectionTrainer.train_step``s of a tiny YOLO or MoE-YOLO, the
port against the JAX trainer on the CPU (shared by
tests/test_torch_yolo_train.py and tests/test_torch_moe_yolo_train.py).

Variant n at 64×128, B=2, 3 ground-truth slots (the last one padded), a
solar bin per frame, the trainer's default configuration (SGD-Nesterov,
lr0 0.01, momentum 0.937, weight decay 5e-4, 3 warm-up epochs, HSV jitter
and flips) with one step per epoch: lr 0 on the first step, lr0/3 on the
second, so the parameters after step 2 carry both steps' gradients (the
momentum trace). The JAX trainer runs on a one-device mesh. Its draws are
recorded with ``jax.debug.callback`` and fed to the port: the augmentation,
the TAL assignment (``assign_targets``, on detached scores and boxes) and,
for MoE-YOLO, each level's top-2 expert choice. The port's own assignment
and expert choice are recorded as well, so a test can show where they
differ from JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import as_torch, detection_batches, jax_augment_draws, load_flax, numpy_variables
from multimodal_moe_torch.losses import tal as tt
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.train import detection as td
from multimodal_moe_tpu.losses import tal as jt
from multimodal_moe_tpu.models import moe as jm
from multimodal_moe_tpu.ops import augment as jaug
from multimodal_moe_tpu.train import state as js

H, W, B, STEPS = 64, 128, 2, 2
CFG = dict(variant="n", img_h=H, img_w=W, epochs=4, batch=B)
SPE = 1
LR_STEP2 = 0.01 / 3


def flax_variables(jmodel, seed: int):
    """``numpy_variables`` with Flax's class prior bias (−4.6) and, for an
    MoE model, expert weights at LeCun scale and spread routers (router
    kernel N(0, 4/d), context bias N(0, 1)) so that the experts matter and
    the bins move the routing."""
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), seed=seed)
    p = variables["params"]
    for i in range(3):
        p["head"][f"cls{i}_pred"]["bias"][:] = -4.6
    rng = np.random.default_rng(seed + 100)
    for i in range(3):
        lvl = p.get(f"moe_level{i}")
        if lvl is None:
            continue
        e, d, h = lvl["experts_w1"].shape
        lvl["experts_w1"] = rng.normal(0, d ** -0.5, (e, d, h)).astype(np.float32)
        lvl["experts_w2"] = rng.normal(0, h ** -0.5, (e, h, d)).astype(np.float32)
        lvl["router"]["router_kernel"] = rng.normal(0, 2 * d ** -0.5, (d, e)).astype(np.float32)
        lvl["router"]["context_bias"] = rng.normal(0, 1.0, (6, e)).astype(np.float32)
    return variables


def batches():
    out = detection_batches(STEPS, H, W, b=B, m=3, seed=4)
    for i, batch in enumerate(out):
        batch["solar_bin"] = np.array([1 + i, 4], np.int32)
    return out


def run_pair(jmodel, tmodel_template, loss_pair, seed: int) -> dict:
    """Both trainers over the same two batches; ``loss_pair`` = (JAX loss,
    port loss). Returns the states, the per-step metrics and the records."""
    from multimodal_moe_tpu.parallel.mesh import create_mesh, replicated
    from multimodal_moe_tpu.train.detection import DetectionTrainer as JaxTrainer
    from multimodal_moe_tpu.train.detection import DetTrainConfig as JaxConfig

    variables = flax_variables(jmodel, seed)
    jtrainer = JaxTrainer(jmodel, JaxConfig(**CFG), steps_per_epoch=SPE, loss_fn=loss_pair[0],
                          mesh=create_mesh(devices=jax.devices()[:1]))
    # init_state without its init compile: the same chain on numpy weights.
    jtrainer._tx = js.make_optimizer(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=5e-4,
                                     warmup_steps=int(SPE * 3.0), total_steps=SPE * CFG["epochs"],
                                     optimizer="sgd")
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax.device_put(js.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jtrainer._tx.init(params), ema_params=jax.tree.map(jnp.copy, params)),
        replicated(jtrainer.mesh))

    rec = {"augment": [], "assign": [], "route": []}
    real = (jaug.train_augment, jt.assign_targets, jm.route_top_k_dropless)

    def augment(images, boxes, rng, **kw):
        jax.debug.callback(lambda d: rec["augment"].append(jax.tree.map(np.asarray, d)),
                           jax_augment_draws(rng, images.shape[0]))
        return real[0](images, boxes, rng, **kw)

    def assign(*args):
        out = real[1](*args)
        jax.debug.callback(lambda *a: rec["assign"].append([np.asarray(x) for x in a]), *out)
        return out

    def route(logits, **kw):
        out = real[2](logits, **kw)
        jax.debug.callback(lambda idx: rec["route"].append(np.asarray(idx)), out[0])
        return out

    data = batches()
    jax_metrics = []
    jaug.train_augment, jt.assign_targets, jm.route_top_k_dropless = augment, assign, route
    try:
        for batch in data:
            jstate, metrics = jtrainer.train_step(jstate, batch)
            jax_metrics.append(jax.device_get(metrics))
        jax.effects_barrier()
    finally:
        jaug.train_augment, jt.assign_targets, jm.route_top_k_dropless = real
    assert len(rec["augment"]) == len(rec["assign"]) == STEPS

    template = load_flax(tmodel_template, variables)
    trainer = td.DetectionTrainer(template, td.DetTrainConfig(**CFG), steps_per_epoch=SPE,
                                  loss_fn=loss_pair[1], device=torch.device("cpu"))
    state = trainer.init_state()
    own = {"assign": [], "route": []}
    routes = list(rec["route"])
    real_port = (tt.assign_targets, tm.stable_topk)

    def port_assign(*args, step):
        own["assign"].append(real_port[0](*args))
        return tt.AssignResult(*(torch.from_numpy(np.array(a)) for a in rec["assign"][step]))

    def port_topk(probs, k):
        own["route"].append(real_port[1](probs, k)[1])
        # JAX's callbacks are unordered within a step: the level's token
        # count picks its record (the steps run one after the other).
        j = next(j for j, r in enumerate(routes) if r.shape[0] == probs.shape[0])
        idx = torch.from_numpy(routes.pop(j).astype(np.int64))
        return torch.gather(probs, 1, idx), idx

    metrics = []
    try:
        tm.stable_topk = port_topk
        for i, batch in enumerate(data):
            tt.assign_targets = lambda *a, i=i: port_assign(*a, step=i)
            state, m = trainer.train_step(state, trainer._to_device(batch),
                                          draws={"augment": as_torch(rec["augment"][i])})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        tt.assign_targets, tm.stable_topk = real_port
    return dict(jstate=jax.device_get(jstate), jax_metrics=jax_metrics, state=state,
                metrics=metrics, variables=variables, rec=rec, own=own)
