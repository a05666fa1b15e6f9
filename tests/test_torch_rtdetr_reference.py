"""RT-DETR in the port against the benchmark's plain reference
(``gpubench/reference/rtdetr.py``, plain torch, no JAX, nothing of the
port) on seeded random weights, on the CPU at a small size: hidden 64,
backbone depths (1, 1, 1, 1), 2 decoder layers, 24 queries, 64×96 images,
6 ground-truth slots. The weights are the benchmark's (its seeded rules and
its fit to four frames); the reference is given the port's top-24 anchors
and its matcher's assignment wherever the two are compared on logits or
losses, and the picks are compared apart, where a margin says they must
agree.

Tolerances, relative L2 unless said otherwise. Float32 on both sides: the
port and the reference run the same products in another grouping (fused
Linear and conv, ``grid_sample`` against the kernels' plain gathers), so
they agree to float32's summation error, ~1e-6 of each output, grown by
the decoder's refinement: 1e-5 for the encoder's logits and selected
boxes, 1e-4 for the final logits and boxes (measured 1e-6 to 8e-6). Train
mode adds BatchNorm's batch statistics by E[x²] − E[x]², whose cancellation
spreads the summation error (measured to 3e-6): 1e-4 there too, the loss
1e-5. Gradients: every tensor within 1e-3 of its norm plus 1e-6 of the
whole gradient's, the whole within 1e-4 (measured 5e-8 median). bf16: the
port stores every activation in bfloat16 (2⁻⁹ relative) through some
thirty layers; the encoder's logits within 5e-2, the final logits within
1e-1 and the boxes within 1.5e-2 of float32's (measured 1.5e-2, 3.3e-2 and
4.5e-3), where the reference computed with fp8 operands lies at 1.6e-1,
2.5e-1 and 4.6e-2 and fails every bound.
"""

import numpy as np
import pytest
import torch

from gpubench import common, rtdetr_common
from gpubench.drivers.rtdetr_offline import select_gap
from gpubench.reference import rtdetr as ref
from gpubench.reference.detector import Prec
from multimodal_moe_torch.losses.hungarian import _gt_cxcywh, hungarian_match
from multimodal_moe_torch.models.rtdetr import rtdetr_loss
from multimodal_moe_torch.ops.assignment import assignment_margin
from multimodal_moe_torch.train.state import make_train_state
from multimodal_moe_torch.utils import profiler

torch.set_num_threads(2)

H, W, SLOTS, B = 64, 96, 6, 2
CFG = dict(common.load_json("configs", "rtdetr_r50vd"), hidden_dim=64, aifi_ffn_dim=256,
           backbone_depths=[1, 1, 1, 1], num_decoder_layers=2, num_queries=24)
HP = dict(lr0=1e-4, lrf=1.0, weight_decay=1e-4, warmup_steps=3, total_steps=100)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def setup():
    frames = common.make_frames(6, H, W, 11, "cpu")
    gt = common.make_ground_truth(B, SLOTS, H, W, 11, "cpu", max_count=4)
    weights = {}
    for dtype in (torch.float32, torch.bfloat16):
        w = rtdetr_common.make_weights(rtdetr_common.weight_shapes(CFG, dtype), CFG, 11, "cpu")
        rtdetr_common.fit_to_frames(w, CFG, frames[:4])
        weights[dtype] = w
    return frames[4:], gt, weights


def _port_eval(w, dtype, images):
    model = rtdetr_common.build_model(CFG, dtype, "cpu", w)
    sel = rtdetr_common.SelectionCapture(model)
    sel.on = True
    with torch.no_grad():
        out = model(images.float() / 255.0)
    return out, sel.taken[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_eval_forward_matches_the_reference(setup, dtype):
    images, _, weights = setup
    out, (enc, topk) = _port_eval(weights[dtype], dtype, images)
    assert bool((topk >= 0).all())                     # every pick found in the memory
    w32 = {k: v.float() for k, v in weights[dtype].items()}
    with torch.no_grad():
        want = ref.forward(w32, CFG, images, topk=topk)
        own = ref.forward(w32, CFG, images)
    errs = {"enc": _rel(enc, want["enc_logits"][..., 0]),
            "logits": _rel(out["pred_logits"], want["pred_logits"]),
            "boxes": _rel(out["pred_boxes"], want["pred_boxes"]),
            "pixels": _rel(out["boxes"], want["boxes"]),
            "enc_topk": _rel(out["enc_outputs"]["pred_boxes"], want["enc_outputs"]["pred_boxes"])}
    tol = ({"enc": 1e-5, "logits": 1e-4, "boxes": 1e-4, "pixels": 1e-4, "enc_topk": 1e-5}
           if dtype == torch.float32 else
           {"enc": 5e-2, "logits": 1e-1, "boxes": 1.5e-2, "pixels": 1.5e-2, "enc_topk": 1.5e-2})
    assert all(errs[k] <= tol[k] for k in tol), errs
    # The port's own selection agrees with the reference's wherever the
    # scores are further apart than the logits' difference allows.
    _, valid = ref.anchors([(H // s, W // s) for s in (8, 16, 32)], "cpu")
    assert select_gap(topk, enc, own["enc_logits"][..., 0], valid, CFG["num_queries"]) == 0
    if dtype == torch.float32:
        assert torch.equal(topk, own["topk"])


def test_bf16_tolerance_fails_the_fp8_reference(setup):
    """The bf16 bounds above are tight enough that the reference computed
    with fp8 operands, one precision further down, falls outside each."""
    images, _, weights = setup
    w32 = {k: v.float() for k, v in weights[torch.bfloat16].items()}
    with torch.no_grad():
        want = ref.forward(w32, CFG, images)
        fp8 = ref.forward(w32, CFG, images, topk=want["topk"], prec=Prec("fp8"))
    assert _rel(fp8["pred_logits"], want["pred_logits"]) > 1e-1
    assert _rel(fp8["pred_boxes"], want["pred_boxes"]) > 1.5e-2
    assert _rel(fp8["enc_logits"], want["enc_logits"]) > 5e-2


def _train_pair(setup):
    """The port's train-mode forward and loss and the reference's, on the
    same denoising draws, the reference given the port's picks."""
    images, gt, weights = setup
    w = weights[torch.float32]
    model = rtdetr_common.build_model(CFG, torch.float32, "cpu", w, train=True)
    sel = rtdetr_common.SelectionCapture(model)
    sel.on = True
    gen = torch.Generator().manual_seed(3)
    draws = ref.denoise_draws(B, SLOTS, CFG["num_denoising_groups"], gen, "cpu")
    x = images.float() / 255.0
    out = model(x, train=True, gt_boxes=gt["gt_boxes"], gt_mask=gt["gt_mask"], dn_draws=draws)
    loss, _ = rtdetr_loss(out, gt["gt_labels"], gt["gt_boxes"], gt["gt_mask"], img_hw=(H, W))
    layers = ref.matched_layers(out)
    n = len(layers)
    with torch.no_grad():
        assigned = hungarian_match(
            torch.cat([ly["pred_logits"] for ly in layers]),
            torch.cat([ly["pred_boxes"] for ly in layers]), gt["gt_labels"].repeat(n, 1),
            _gt_cxcywh(gt["gt_boxes"], (H, W)).repeat(n, 1, 1), gt["gt_mask"].repeat(n, 1))
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()
              if ref.is_param(k)}
    wts = dict(w, **params)
    want = ref.forward_float(wts, CFG, x, train=True, topk=sel.taken[0][1],
                             gt_boxes=gt["gt_boxes"], gt_mask=gt["gt_mask"], dn_draws=draws)
    mine = ref.set_loss(want, gt["gt_labels"], gt["gt_boxes"], gt["gt_mask"], img_hw=(H, W),
                        assigned=assigned.view(n, B, -1))
    return model, out, loss, assigned.view(n, B, -1), params, want, mine


def test_train_forward_with_given_draws_matches(setup):
    _, out, _, _, _, want, _ = _train_pair(setup)
    assert out["dn_outputs"][0]["pred_logits"].shape[1] == 2 * CFG["num_denoising_groups"] * SLOTS
    assert torch.equal(out["dn_is_pos"], want["dn_is_pos"])
    pairs = [(out, want)] + list(zip(out["aux_outputs"], want["aux_outputs"])) \
        + list(zip(out["dn_outputs"], want["dn_outputs"])) \
        + [(out["enc_outputs"], want["enc_outputs"])]
    for got, exp in pairs:
        assert _rel(got["pred_logits"], exp["pred_logits"]) < 1e-4
        assert _rel(got["pred_boxes"], exp["pred_boxes"]) < 1e-4


def test_loss_on_a_given_assignment_and_the_matchers_agreement(setup):
    """The set loss on the port's assignment; the reference's own matcher
    agrees with the port's wherever the optimum is unique by more than the
    cost entries' difference allows (``assignment_margin`` > 2·columns·δ)."""
    images, gt, _ = setup
    _, out, loss, assigned, _, want, mine = _train_pair(setup)
    assert abs(float(loss.detach()) - float(mine["loss"].detach())) \
        <= 1e-5 * abs(float(mine["loss"].detach()))
    gt_c = ref.gt_to_cxcywh(gt["gt_boxes"], H, W)
    prog_cost = ref.layer_costs(out, gt_c, gt["gt_labels"], gt["gt_mask"])
    n = prog_cost.shape[0] // B
    valid = gt["gt_mask"].repeat(n, 1)
    own = ref.assign(mine["cost"], valid)
    checked = 0
    for p in range(n * B):
        cols = valid[p]
        delta = float((prog_cost[p][:, cols] - mine["cost"][p][:, cols]).abs().max())
        if assignment_margin(mine["cost"][p].numpy(), cols.numpy()) > 2 * int(cols.sum()) * delta:
            assert torch.equal(own[p][cols], assigned.view(n * B, -1)[p][cols])
            checked += 1
    assert checked >= n * B // 2


def test_gradients_match(setup):
    m, _, loss, _, params, _, mine = _train_pair(setup)
    names, ps = zip(*m.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)))
    exp = dict(zip(params, torch.autograd.grad(mine["loss"], list(params.values()),
                                               allow_unused=True, materialize_grads=True)))
    total = torch.linalg.vector_norm(torch.stack([e.norm() for e in exp.values()]))
    whole = torch.linalg.vector_norm(torch.stack([(got[k] - exp[k]).norm() for k in exp]))
    assert float(whole) <= 1e-4 * float(total)
    for k in exp:
        assert float((got[k] - exp[k]).norm()) <= 1e-3 * float(exp[k].norm()) + 1e-6 * float(total), k


def test_one_adamw_clip_ema_step_matches(setup):
    """``TrainState.apply_gradients`` (AdamW, clip at 10, the EMA) against the
    reference's step, from the same weights and gradients, with the global
    norm above 10 so that the clip acts, at the second update (the first has
    lr 0 under the warmup)."""
    _, _, weights = setup
    w = weights[torch.float32]
    model = rtdetr_common.build_model(CFG, torch.float32, "cpu", w, train=True)
    state = make_train_state(model, lr0=HP["lr0"], lrf=HP["lrf"],
                             weight_decay=HP["weight_decay"], warmup_steps=HP["warmup_steps"],
                             total_steps=HP["total_steps"], optimizer="adamw")
    gen = torch.Generator().manual_seed(5)
    grads = [{k: torch.randn(p.shape, generator=gen) * 0.1 for k, p in model.named_parameters()}
             for _ in range(2)]
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    ema = {k: p.clone() for k, p in params.items()}
    for step, g in enumerate(grads):
        state.apply_gradients({k: v.clone() for k, v in g.items()})
        clipped = ref.adamw_step(params, g, mu, nu, ema, step, HP)
    assert float(torch.linalg.vector_norm(torch.stack([v.norm() for v in clipped.values()]))) \
        == pytest.approx(10.0, rel=1e-5)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state.ema_params[k], ema[k], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state.opt.state["mu"][k], mu[k], rtol=1e-6, atol=1e-12)


SPANS = {"rtdetr.backbone": set(), "rtdetr.encoder": set(),
         "rtdetr.select": {"anchors", "queries"}, "rtdetr.decoder": {"queries", "layers"},
         "rtdetr.deform": {"batch", "value_rows", "queries", "heads", "levels", "points"},
         "detr.match": {"problems", "columns"}}


def _spanned_step(setup):
    images, gt, weights = setup
    model = rtdetr_common.build_model(CFG, torch.float32, "cpu", weights[torch.float32],
                                      train=True)
    gen = torch.Generator().manual_seed(4)
    out = model(images.float() / 255.0, train=True, gt_boxes=gt["gt_boxes"],
                gt_mask=gt["gt_mask"], denoise_generator=gen)
    rtdetr_loss(out, gt["gt_labels"], gt["gt_boxes"], gt["gt_mask"], img_hw=(H, W))


def test_spans_log_their_counts_under_the_profiler(setup):
    _, gt, _ = setup
    profiler.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _spanned_step(setup)
        log = profiler.spans()
    finally:
        profiler.clear_spans()
    by_name = {}
    for s in log:
        by_name.setdefault(s["name"], []).append(s)
    assert set(SPANS) <= set(by_name)
    for name, keys in SPANS.items():
        assert all(set(s["counts"]) == keys for s in by_name[name]), name
    layers = CFG["num_decoder_layers"]
    d = 2 * CFG["num_denoising_groups"] * SLOTS
    anchors = sum((H // s) * (W // s) for s in (8, 16, 32))
    assert by_name["rtdetr.select"][0]["counts"] == {"anchors": anchors,
                                                     "queries": CFG["num_queries"]}
    assert by_name["rtdetr.decoder"][0]["counts"] == {"queries": CFG["num_queries"] + d,
                                                      "layers": layers}
    assert len(by_name["rtdetr.deform"]) == layers
    assert all(s["parent"] == "rtdetr.decoder" for s in by_name["rtdetr.deform"])
    assert by_name["rtdetr.deform"][0]["counts"] == {
        "batch": B, "value_rows": anchors, "queries": CFG["num_queries"] + d,
        "heads": CFG["num_heads"], "levels": 3, "points": CFG["num_points"]}
    assert by_name["detr.match"][0]["counts"] == {
        "problems": (layers + 1) * B, "columns": (layers + 1) * int(gt["gt_mask"].sum())}


def test_spans_log_nothing_with_the_profiler_off(setup):
    profiler.clear_spans()
    _spanned_step(setup)
    assert profiler.spans() == []


def test_count_flops_by_hand():
    """One deformable call's sampling counts 2·4·D multiply-adds a sampled
    point; a Linear 2·in·out a token; the training walk adds the denoising
    queries' decoder work only."""
    shapes = {k: s for k, (s, _) in rtdetr_common.weight_shapes(CFG, torch.float32).items()}
    serve = ref.count_flops(CFG, 1, H, W, shapes)
    train = ref.count_flops(CFG, 1, H, W, shapes, denoising_slots=SLOTS)
    assert serve.by_part["backbone"] == train.by_part["backbone"]
    assert serve.by_part["encoder"] == train.by_part["encoder"]
    assert train.by_part["decoder"] > serve.by_part["decoder"]
    two = ref.count_flops(CFG, 2, H, W, shapes)
    assert two.flops == pytest.approx(2 * serve.flops)
    c, nh, q = CFG["hidden_dim"], CFG["num_heads"], CFG["num_queries"]
    points = q * nh * 3 * CFG["num_points"]
    assert 2 * 4 * (c // nh) * points < serve.by_part["decoder"]
    assert np.isfinite(serve.flops)
