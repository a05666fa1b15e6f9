"""The plain reference against the port at a small size on the CPU: the
two detectors' forwards, the serving tail, and three training steps."""

import pytest
import torch

from gpubench import common
from gpubench import run as bench_run
from gpubench.reference import detector, nms

torch.set_num_threads(2)


def _models(name: str, seed: int):
    # At 64×128 "auto" would pick the dense route (under 4096 tokens a
    # level); the cells' sizes resolve it to the sweep, which the reference
    # computes (every token through its k experts, dropless).
    cfg = dict(common.load_json("configs", name), dispatch="sweep")
    w = common.make_weights(common.weight_shapes(cfg, torch.float32), seed, "cpu")
    return cfg, w, common.build_model(cfg, torch.float32, "cpu", w)


@pytest.mark.parametrize("name", ["yolo_s", "moe_yolo_s"])
def test_forward_matches_the_port(name):
    cfg, w, model = _models(name, 11)
    frames = common.make_frames(2, 64, 128, 11, "cpu")
    bins = common.make_bins(2, 6, 11, "cpu")
    ctx = {"context_ids": bins} if cfg.get("num_experts") else {}
    with torch.no_grad():
        got = model(frames.float() / 255.0, **ctx)
        ref = detector.forward(w, cfg, frames, bins)
    for key in ("cls_logits", "box_logits", "boxes"):
        err = (got[key] - ref[key]).norm() / ref[key].norm()
        assert float(err) < 1e-5, (key, float(err))
    if cfg.get("num_experts"):
        assert torch.allclose(got["moe_aux_loss"], ref["moe_aux_loss"], rtol=1e-5)
        assert torch.equal(got["expert_load"], ref["expert_load"])


def test_tail_matches_the_port_bitwise():
    from multimodal_moe_torch.ops.nms import batched_nms

    gen = torch.Generator().manual_seed(5)
    b, a = 3, 900
    xy = torch.rand((b, a, 2), generator=gen) * 200
    wh = 8 + torch.rand((b, a, 2), generator=gen) * 40
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[1, 10:20] = boxes[1, 0]                                 # identical boxes
    logits = torch.randn((b, a, 1), generator=gen) * 3
    logits[2, :50] = 1.0                                          # score ties
    got = batched_nms(boxes, torch.sigmoid(logits[..., 0]), num_candidates=512)
    ref = nms.serving_tail(logits, boxes, pool=512)
    for g, r in zip(got, ref):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)


def test_three_training_steps_match_the_port():
    """The train cell's check, run on the CPU at 64×128: the port's first
    three steps against the reference's, float32 on both sides."""
    run, line = bench_run.execute(
        ["--workload", "moe_yolo_s.train_b16", "--seed", "7", "--seconds", "0.1",
         "--trace", "0"], device=torch.device("cpu"),
        cell_overrides=dict(batch=2, pool_batches=3, img_h=64, img_w=128, max_boxes=8),
        config_overrides=dict(dispatch="sweep"))
    values = dict(run.info, **{k: v["value"] for k, v in line["checks"].items()})
    assert values["loss_gap"] < 1e-5
    assert values["forward_logit_err"] < 1e-5 and values["forward_box_err"] < 1e-5
    assert values["grad_gap"] < 1e-4
    assert values["update_gap"] < 1e-3 and values["ema_gap"] < 1e-3
