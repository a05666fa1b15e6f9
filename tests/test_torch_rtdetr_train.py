"""RT-DETR in train mode, the port against Flax on the CPU: denoising
queries, the train-mode forward, ``rtdetr_loss``, every parameter's
gradient and the BatchNorm running statistics after the step.

The tiny configuration of tests/test_torch_rtdetr.py (hidden 64, 4 heads,
20 queries, 2 decoder layers, depths (1, 1, 1, 1), 64×128, B=2) with 2
denoising groups over 3 ground-truth slots (one padded): 12 denoising
queries. One jitted ``jax.value_and_grad`` of the JAX step; its denoising
draws and its assignments are recorded (``jax.debug.callback``) and fed to
the port: ``jax.random`` and ``torch.Generator`` draw different numbers.
The port's own assignment is compared with JAX's wherever the optimum is
unique by more than the frameworks' cost difference; the loss and the
gradients are compared on JAX's assignment.

Tolerances (float32). Train mode normalises with batch statistics by
Flax's fast variance E[x²] − E[x]², whose cancellation turns the two
frameworks' different float32 summation orders into larger differences
than eval mode's running averages: one BatchNorm alone differs by 4.4e-5
on inputs of mean 3 and std 0.5, and the trunk stacks 20. So logits and
encoder scores rtol/atol 5e-4 and normalised boxes atol 2e-4 (eval mode:
1e-4 and 1e-5; measured here 3.1e-4 and 8.5e-5); the denoising boxes and mask exact up to 1 ulp; the
loss and its parts rtol 1e-4; running statistics atol 1e-5. Gradients:
the loss has kinks (GIoU's max(·, 0) and min/max corners, the IoU-aware
target switch at IoU 0) that forward differences of 1e-4 can straddle,
and train-mode BatchNorm's backward is ill-conditioned in float32. Each
parameter's gradient is held in norm, ‖g − r‖₂ ≤ 5e-2·‖r‖₂ + 1e-6·‖∇‖₂
with ‖∇‖₂ the norm of the whole JAX gradient (measured worst 2e-2, on a
BatchNorm of the trunk), and the whole gradient within 1e-2 of its norm
(measured 6.4e-3). Against a float64 run of the port's trunk, the port's
float32 trunk gradient is off by 2.8e-6 of its norm and JAX's by 5.5e-3:
the difference is JAX's float32 rounding, and the test asserts that the
port is the closer one. remat on = off exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_denoise_draws,
    load_flax,
    numpy_variables,
    rtdetr_numpy_variables,
    to_numpy,
)
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.losses import hungarian as th
from multimodal_moe_torch.ops.assignment import assignment_margin
from multimodal_moe_torch.models import rtdetr as tr
from multimodal_moe_torch.ops import deformable_kernel as tk
from multimodal_moe_tpu.models import rtdetr as jr
from multimodal_moe_tpu.ops import assignment as ja

H, W = 64, 128
CFG = dict(num_classes=1, hidden_dim=64, num_queries=20, num_decoder_layers=2, num_heads=4,
           backbone_depths=(1, 1, 1, 1))
GT = np.array([[[10.0, 8.0, 50.0, 40.0], [70.0, 20.0, 118.0, 60.0], [0, 0, 0, 0]],
               [[5.0, 30.0, 40.0, 62.0], [60.0, 4.0, 90.0, 30.0], [0, 0, 0, 0]]], np.float32)
GT_MASK = np.array([[True, True, False], [True, True, False]])
GT_LABELS = np.zeros((2, 3), np.int32)
TRAIN_LOGIT_TOL, TRAIN_BOX_TOL = 5e-4, 2e-4


@pytest.mark.parametrize("noise", [1.0, 0.4])
def test_denoising_queries_match_jax(noise):
    rng = np.random.default_rng(0)
    ctr = rng.uniform(0.2, 0.8, (2, 3, 2))
    gt = np.concatenate([ctr, rng.uniform(0.05, 0.3, (2, 3, 2))], -1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jr.build_denoising_queries(key, jnp.asarray(gt), jnp.asarray(GT_MASK), num_groups=2,
                                     num_matching=7, box_noise_scale=noise)
    shift_u, scale_u = (torch.from_numpy(np.asarray(a)) for a in jax_denoise_draws(key, 2, 3))
    got = tr.build_denoising_queries(torch.from_numpy(gt), torch.from_numpy(GT_MASK),
                                     num_groups=2, num_matching=7, box_noise_scale=noise,
                                     shift_u=shift_u, scale_u=scale_u)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].shape == (12 + 7, 12 + 7)


def test_denoising_draws_from_a_generator():
    gt = torch.full((1, 2, 4), 0.5)
    a = tr.build_denoising_queries(gt, torch.ones((1, 2), dtype=torch.bool), num_matching=3,
                                   generator=torch.Generator().manual_seed(0))
    b = tr.build_denoising_queries(gt, torch.ones((1, 2), dtype=torch.bool), num_matching=3,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0], b[0]) and a[0].shape == (1, 8, 4)
    assert ((a[0] > 0) & (a[0] < 1)).all()


# --------------------------------------------------------------------------
# one train step of the tiny detector in both frameworks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step():
    jmodel = jr.RTDETRDetector(**CFG)
    variables = rtdetr_numpy_variables(jmodel, H, W, seed=1)
    images = np.random.default_rng(2).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    rec = {"assign": []}

    real_build, real_assign = jr.build_denoising_queries, ja.batched_lsa_assign

    def build(rng, gt_boxes, gt_mask, **kw):
        jax.debug.callback(lambda s, c: rec.update(draws=(np.asarray(s), np.asarray(c))),
                           *jax_denoise_draws(rng, *gt_boxes.shape[:2]))
        return real_build(rng, gt_boxes, gt_mask, **kw)

    def assign(cost, col_valid=None):
        out = real_assign(cost, col_valid)
        jax.debug.callback(lambda c, a: rec["assign"].append((np.asarray(c), np.asarray(a))),
                           cost, out)
        return out

    def loss_fn(params, stats, x):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, train=True, gt_boxes=jnp.asarray(GT),
            gt_mask=jnp.asarray(GT_MASK), rngs={"denoise": jax.random.PRNGKey(3)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "enc_score")
        total, metrics = jr.rtdetr_loss(out, jnp.asarray(GT_LABELS), jnp.asarray(GT),
                                        jnp.asarray(GT_MASK), img_hw=(H, W))
        return total, (out, mutated, metrics)

    jr.build_denoising_queries, ja.batched_lsa_assign = build, assign
    try:
        (loss, (out, mutated, metrics)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(images))
        jax.block_until_ready(loss)
        jax.effects_barrier()
    finally:
        jr.build_denoising_queries, ja.batched_lsa_assign = real_build, real_assign
    out, mutated, metrics, grads = jax.device_get((out, mutated, metrics, grads))

    # The port: the same weights, JAX's draws and (for the loss) JAX's assignment.
    tmodel = load_flax(tr.RTDETRDetector(**CFG), variables).train()
    enc = []
    hook = tmodel.enc_score.register_forward_hook(lambda m, i, o: enc.append(o.detach().numpy()))
    port_costs = []
    jax_cost, jax_assigned = rec["assign"][0]

    def replay(cost, col_valid=None):
        port_costs.append(cost.numpy())
        return torch.from_numpy(jax_assigned.astype(np.int64))

    shift_u, scale_u = (torch.from_numpy(a) for a in rec["draws"])
    port_out = tmodel(torch.from_numpy(images), train=True, gt_boxes=torch.from_numpy(GT),
                      gt_mask=torch.from_numpy(GT_MASK), dn_draws=(shift_u, scale_u))
    hook.remove()
    th.batched_lsa_assign, real_port_assign = replay, th.batched_lsa_assign
    try:
        port_loss, port_metrics = tr.rtdetr_loss(
            port_out, torch.from_numpy(GT_LABELS), torch.from_numpy(GT),
            torch.from_numpy(GT_MASK), img_hw=(H, W))
    finally:
        th.batched_lsa_assign = real_port_assign
    port_loss.backward()
    return dict(variables=variables, images=images, jax_out=out, jax_stats=mutated["batch_stats"],
                jax_enc=np.asarray(mutated["intermediates"]["enc_score"]["__call__"][0]),
                jax_loss=float(loss), jax_metrics=metrics, jax_grads=grads,
                jax_cost=jax_cost, jax_assigned=jax_assigned, port_cost=port_costs[0],
                draws=(shift_u, scale_u), tmodel=tmodel, port_enc=enc[0],
                port_out=to_numpy({k: v for k, v in port_out.items() if k != "dn_groups"}),
                port_loss=float(port_loss.detach()),
                port_metrics={k: float(v.detach()) for k, v in port_metrics.items()})


def test_query_selection_is_well_defined(step):
    diff = float(np.abs(step["port_enc"] - step["jax_enc"]).max())
    assert diff <= TRAIN_LOGIT_TOL
    valid = tr.anchors_for([(H // s, W // s) for s in (8, 16, 32)])[1]
    scores = np.where(valid[None], step["jax_enc"].max(-1), -1e9)
    k = CFG["num_queries"]
    gaps = -np.diff(-np.sort(-scores, axis=-1)[:, : k + 1], axis=-1)
    assert gaps.min() > 2 * diff, (float(gaps.min()), diff)


def test_train_outputs_match_flax(step):
    ref, got = to_numpy(step["jax_out"]), step["port_out"]
    assert set(got) | {"dn_groups"} == set(ref)
    assert ref["dn_groups"] == 2
    np.testing.assert_array_equal(got["dn_is_pos"], ref["dn_is_pos"])
    heads = ([("final", got, ref), ("enc", got["enc_outputs"], ref["enc_outputs"])]
             + [(f"aux{i}", g, r) for i, (g, r) in enumerate(zip(got["aux_outputs"],
                                                                 ref["aux_outputs"]))]
             + [(f"dn{i}", g, r) for i, (g, r) in enumerate(zip(got["dn_outputs"],
                                                                ref["dn_outputs"]))])
    assert len(got["dn_outputs"]) == CFG["num_decoder_layers"]
    for tag, g, r in heads:
        assert g["pred_logits"].shape == r["pred_logits"].shape
        np.testing.assert_allclose(g["pred_logits"], r["pred_logits"], rtol=TRAIN_LOGIT_TOL,
                                   atol=TRAIN_LOGIT_TOL, err_msg=f"{tag} logits")
        np.testing.assert_allclose(g["pred_boxes"], r["pred_boxes"], rtol=0,
                                   atol=TRAIN_BOX_TOL, err_msg=f"{tag} boxes")
    assert got["dn_outputs"][0]["pred_boxes"].shape == (2, 12, 4)


def test_assignments_match_where_well_defined(step):
    """The port's own solve of its own cost equals JAX's assignment for
    every problem (layer × image) whose optimum is unique by more than 2·M
    times the largest cost difference; the others replay JAX's."""
    delta = float(np.abs(step["port_cost"] - step["jax_cost"]).max())
    own = th.batched_lsa_assign(torch.from_numpy(step["port_cost"]),
                                torch.from_numpy(np.tile(GT_MASK, (3, 1)))).numpy()
    checked = 0
    for i, valid in enumerate(np.tile(GT_MASK, (3, 1))):
        if assignment_margin(step["jax_cost"][i], valid) > 2 * valid.sum() * delta:
            np.testing.assert_array_equal(own[i][valid], step["jax_assigned"][i][valid])
            checked += 1
    assert checked >= 1, "no matching problem was well defined"


def test_loss_and_metrics_match_flax(step):
    np.testing.assert_allclose(step["port_loss"], step["jax_loss"], rtol=1e-4)
    assert set(step["port_metrics"]) == set(step["jax_metrics"])
    for k, v in step["jax_metrics"].items():
        np.testing.assert_allclose(step["port_metrics"][k], float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_every_gradient_matches_flax(step):
    ref = {k: v.numpy().astype(np.float64)
           for k, v in flax_to_state_dict({"params": step["jax_grads"]}).items()}
    params = dict(step["tmodel"].named_parameters())
    assert set(ref) == set(params)
    total = np.sqrt(sum(float((r * r).sum()) for r in ref.values()))
    diff2 = 0.0
    for name, p in params.items():
        d = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert d <= 5e-2 * np.linalg.norm(ref[name]) + 1e-6 * total, (name, d)
        diff2 += d * d
    print(f"whole gradient: |port - JAX| = {np.sqrt(diff2) / total:.2e} of its norm")
    assert np.sqrt(diff2) <= 1e-2 * total
    for name in ("decoder0.cross_attn.value_proj.weight",
                 "decoder1.cross_attn.sampling_offsets.weight",
                 "decoder0.cross_attn.attention_weights.weight", "dn_content_embed",
                 "enc_score.weight", "backbone._ConvBN_0.Conv_0.weight"):
        assert params[name].grad.abs().max() > 0, name


def test_trunk_gradient_against_float64():
    """Train-mode BatchNorm's backward: the trunk's float32 gradients of
    both frameworks against a float64 run of the port's trunk."""
    from multimodal_moe_torch.models.resnet import ResNet as TorchResNet
    from multimodal_moe_tpu.models.resnet import ResNet as JaxResNet

    jmodel = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=None, vd=True)
    x = np.random.default_rng(4).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), train=False, seed=5)
    rng = np.random.default_rng(6)
    weights = [rng.normal(size=(2, H // s, W // s, c)).astype(np.float32)
               for s, c in ((4, 256), (8, 512), (16, 1024), (32, 2048))]

    def loss(params):
        outs, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    ref = flax_to_state_dict({"params": jax.device_get(jax.jit(jax.grad(loss))(
        variables["params"]))})
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = load_flax(TorchResNet(stage_sizes=(1, 1, 1, 1)), variables).to(dtype).train()
        outs = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype))
        sum((o * torch.from_numpy(w.transpose(0, 3, 1, 2).copy()).to(dtype)).sum()
            for o, w in zip(outs, weights)).backward()
        grads[dtype] = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    port_err = jax_err = total = 0.0
    for name, truth in grads[torch.float64].items():
        norm = np.linalg.norm(truth)
        d_port = np.linalg.norm(grads[torch.float32][name] - truth)
        d_jax = np.linalg.norm(ref[name].numpy() - truth)
        assert d_port <= 5e-2 * norm and d_jax <= 5e-2 * norm, (name, d_port / norm, d_jax / norm)
        port_err, jax_err, total = port_err + d_port**2, jax_err + d_jax**2, total + norm**2
    port_err, jax_err = np.sqrt(port_err / total), np.sqrt(jax_err / total)
    print(f"trunk gradient vs float64: port {port_err:.2e}, JAX {jax_err:.2e}")
    assert port_err <= jax_err <= 1e-2


def test_batch_stats_match_flax(step):
    ref = flax_to_state_dict({"batch_stats": step["jax_stats"]})
    got = step["tmodel"].state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    before = flax_to_state_dict(step["variables"])
    assert any(not np.allclose(got[k].numpy(), before[k].numpy()) for k in stats)


def test_remat_changes_nothing(step):
    """``remat=True`` recomputes the backbone blocks during backward; the
    loss, every gradient and the running statistics are those of the
    fixture's run without it (the recompute does not move the running
    averages a second time). Both losses solve the same assignment."""
    model = load_flax(tr.RTDETRDetector(**CFG, remat=True), step["variables"]).train()
    out = model(torch.from_numpy(step["images"]), train=True, gt_boxes=torch.from_numpy(GT),
                gt_mask=torch.from_numpy(GT_MASK), dn_draws=step["draws"])
    replay = lambda cost, col_valid=None: torch.from_numpy(step["jax_assigned"].astype(np.int64))  # noqa: E731
    real, th.batched_lsa_assign = th.batched_lsa_assign, replay
    try:
        loss, _ = tr.rtdetr_loss(out, torch.from_numpy(GT_LABELS), torch.from_numpy(GT),
                                 torch.from_numpy(GT_MASK), img_hw=(H, W))
    finally:
        th.batched_lsa_assign = real
    loss.backward()
    assert float(loss.detach()) == step["port_loss"]
    reference = dict(step["tmodel"].named_parameters())
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, reference[k].grad), k
    ref_state = step["tmodel"].state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_state[k]), k


def test_cpu_training_takes_no_kernel(step):
    assert tk.ms_deform_fwd_launches == 0 and tk.ms_deform_bwd_launches == 0
