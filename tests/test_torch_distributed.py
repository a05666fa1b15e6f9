"""The port's multi-rank training step against its one-process step on the
global batch (CPU, gloo ranks with two torch threads each).

* ``dryrun_multichip(4, device="cpu")``: MoE-YOLO-n on ``sweep`` at 64×128
  on a 2 data × 2 expert mesh (JAX's dry run: its batch, its ground
  truth), against ``DetectionTrainer`` without a mesh on the whole batch
  (the step ``tests/test_torch_moe_yolo_train.py`` holds to JAX). The
  first step's learning rate is 0 (one warm-up step), so the parameters
  must come back unchanged and the gradients are read from the momentum
  trace (``g + wd·p``).
* YOLO-n, two steps on 2 × 1 (``_torch_rank_worker.py``'s ``train``
  case: the rows of each global batch through ``prefetch_to_device``)
  against two one-process steps; the second step moves the parameters.
* A 2-rank ``fit`` of MoE-YOLO-n (2 experts, one a rank on a 1 × 2 mesh,
  a process shard a rank): a pause after one epoch, a resume to the end,
  the replicated checksum equal on both ranks, ``weights/last`` in the
  one-process layout (it loads into a one-process ``TrainState`` bitwise),
  and a checkpoint without optimizer state read on the mesh with each
  rank's expert rows.
* RT-DETR on a 2-rank mesh raises ``NotImplementedError``.

Torch runs two intra-op threads here and in each rank; the one-process
references are computed while the ranks run.

Tolerances: the loss within 1e-5 relative; each parameter within 1e-3 of
the norm of its update plus one float32 ulp an element (``p + update`` is
rounded: a BatchNorm scale of 1.0 moved by ~1e-5 differs by an ulp),
each momentum trace within 1e-3 of its norm; the
BatchNorm running statistics within 1e-6 relative to the scale they
normalise by (``|Δmean| ≤ 1e-6·√var`` and ``|Δvar| ≤ 1e-6·var``, element
for element: a running mean near 0 has no scale of its own); the routing
identical (each MoE level's top-2 expert sets from the router logits, which
agree within 1e-4).
"""

import contextlib
import copy
import io
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_moe_torch.entry import dryrun_batch, dryrun_model, dryrun_multichip
from multimodal_moe_torch.models.moe_yolo import moe_yolo_loss
from multimodal_moe_torch.parallel.distributed import run_ranks
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig
from multimodal_moe_torch.train.state import CheckpointManager, make_train_state

WORKER = Path(__file__).with_name("_torch_rank_worker.py")
sys.path.insert(0, str(WORKER.parent))
from _torch_rank_worker import fit_template, yolo_template  # noqa: E402

CPU = torch.device("cpu")
TRAIN_CFG = dict(variant="n", img_h=64, img_w=128, epochs=4, batch=4)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _batches(n, h, w, b, seed):
    """Seeded uint8 frames with three box slots, the last one padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x1 = rng.uniform(0, w - 40, (b, 3, 1))
        y1 = rng.uniform(0, h - 30, (b, 3, 1))
        boxes = np.concatenate([x1, y1, x1 + rng.uniform(12, 40, (b, 3, 1)),
                                y1 + rng.uniform(12, 30, (b, 3, 1))], -1).astype(np.float32)
        mask = np.ones((b, 3), bool)
        mask[:, -1] = False
        out.append({"image": rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8),
                    "gt_boxes": boxes, "gt_labels": np.zeros((b, 3), np.int32),
                    "gt_mask": mask})
    return out


def _one_process(template, cfg, batches, loss_fn=None, routers=False):
    kw = {"loss_fn": loss_fn} if loss_fn else {}
    trainer = DetectionTrainer(template, DetTrainConfig(**cfg), steps_per_epoch=1, device=CPU,
                               **kw)
    state = trainer.init_state()
    before = copy.deepcopy(state.model.state_dict())
    logits = {}
    hooks = [getattr(state.model, f"moe_level{i}").router.register_forward_hook(
        lambda m, a, o, i=i: logits.__setitem__(i, o.detach())) for i in range(3)] \
        if routers else []
    metrics = []
    for batch in batches:
        state, m = trainer.train_step(state, trainer._to_device(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    for h in hooks:
        h.remove()
    return {"before": before, "state": state.state_dict(), "metrics": metrics, "logits": logits}


def _assert_step_equal(got: dict, ref: dict, before: dict):
    for k, want in ref["model"].items():
        have = got["model"][k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(have, want), k
        elif k.endswith("running_mean"):
            var = ref["model"][k.replace("running_mean", "running_var")]
            assert bool(((have - want).abs() <= 1e-6 * var.sqrt()).all()), k
        elif k.endswith("running_var"):
            assert bool(((have - want).abs() <= 1e-6 * want).all()), k
        else:
            # p + update rounds to float32: one ulp an element on top.
            step = (want - before[k]).norm()
            ulp = torch.finfo(torch.float32).eps * want.norm()
            assert (have - want).norm() <= 1e-3 * step + ulp, (k, float((have - want).norm()),
                                                                float(step))
    for k, want in ref["opt_state"]["trace"].items():
        have = got["opt_state"]["trace"][k]
        assert (have - want).norm() <= 1e-3 * want.norm(), k


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "rank0.pt"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun_multichip, 4, device="cpu", save_to=path)
        batch = {k: torch.from_numpy(v) for k, v in dryrun_batch(4).items()}
        cfg = dict(variant="n", img_h=64, img_w=128, epochs=1, batch=4)
        ref = _one_process(dryrun_model(2), cfg, [batch], moe_yolo_loss, routers=True)
        summary = ranks.result()
    record = torch.load(path, weights_only=True)
    return {"summary": summary, "printed": printed.getvalue(), "record": record, "ref": ref}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_ranks")
    batches = _batches(2, 64, 128, 4, seed=4)
    for i, b in enumerate(batches):
        b["solar_bin"] = np.array([1 + i, 4, 0, 5], np.int32)
    rng = np.random.default_rng(7)
    fit_data = {**{k: np.concatenate([b[k] for b in _batches(2, 64, 64, 4, seed=9)])
                   for k in ("image", "gt_boxes", "gt_labels", "gt_mask")},
                "solar_bin": rng.integers(0, 6, 8).astype(np.int32)}
    fit_cfg = dict(variant="n", img_h=64, img_w=64, epochs=3, batch=4, hsv_aug=False,
                   hflip_prob=0.0)
    torch.save({"cfg": TRAIN_CFG, "batches": batches, "fit_data": fit_data, "fit_cfg": fit_cfg,
                "fit_local_batch": 2}, work / "train_in.pt")
    with ThreadPoolExecutor(1) as pool:
        launch = pool.submit(run_ranks, [sys.executable, str(WORKER), "train", str(work)], 2,
                             env={"OMP_NUM_THREADS": "2"}, timeout=600)
        ref = _one_process(yolo_template(), TRAIN_CFG, batches)
        launch.result()
    got = [torch.load(work / f"train_rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": got, "ref": ref, "work": work, "fit_cfg": fit_cfg}


def test_dryrun_prints_jax_line(dryrun):
    line = dryrun["printed"].strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'expert': 2} step=1 loss=")
    assert line.endswith("dispatch=sweep")
    assert dryrun["summary"]["ranks"] == 4 and dryrun["summary"]["backend"] == "gloo"


def test_dryrun_step_equals_one_process(dryrun):
    got, ref = dryrun["record"], dryrun["ref"]
    for key, want in ref["metrics"][0].items():
        np.testing.assert_allclose(float(got["metrics"][key]), want, rtol=1e-5, err_msg=key)
    _assert_step_equal(got["state"], ref["state"], ref["before"])
    for k, p in ref["state"]["model"].items():   # lr 0 on the first step
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(got["state"]["model"][k], ref["before"][k]), k


def test_dryrun_routing_equals_one_process(dryrun):
    got, ref = dryrun["record"]["router_logits"], dryrun["ref"]["logits"]
    for i in range(3):
        assert got[i].shape == ref[i].shape
        assert float((got[i] - ref[i]).abs().max()) < 1e-4
        pick = lambda x: torch.sort(torch.topk(torch.softmax(x, -1), 2).indices, -1).values  # noqa
        assert torch.equal(pick(got[i]), pick(ref[i])), i


def test_yolo_two_by_one_equals_one_process(ranks):
    ref = ranks["ref"]
    for r in ranks["ranks"]:
        got = r["yolo"]
        for step, want in enumerate(ref["metrics"]):
            for key, value in want.items():
                np.testing.assert_allclose(got["metrics"][step][key], value, rtol=1e-5,
                                           err_msg=f"step {step} {key}")
        _assert_step_equal(got["state"], ref["state"], ref["before"])
    moved = [k for k, p in ref["state"]["model"].items() if "running" not in k
             and not k.endswith("num_batches_tracked") and not torch.equal(p, ref["before"][k])]
    assert len(moved) > 10   # the second step's learning rate moves the parameters


def test_rtdetr_on_a_mesh_raises(ranks):
    for r in ranks["ranks"]:
        assert r["rtdetr_raises"] is not None and "ROADMAP.md" in r["rtdetr_raises"]


def test_two_rank_fit_pauses_and_resumes(ranks):
    fits = [r["fit"] for r in ranks["ranks"]]
    for f in fits:
        assert f["step_after_pause"] == 2 and f["step"] == 6   # 2 global steps an epoch
        assert f["first"]["epochs_run"] == 1 and not f["first"]["completed"]
        assert f["second"]["epochs_run"] == 3 and f["second"]["completed"]
        assert f["local_expert_shape"][0] == 1                 # one expert a rank
        assert f["restore_eval_rows"]
        assert all(np.isfinite(row["loss"]) for row in f["second"]["history"])
    assert fits[0]["replicated_checksum"] == fits[1]["replicated_checksum"]
    assert fits[0]["second"]["history"] == fits[1]["second"]["history"]   # global metrics
    for k, v in fits[0]["state"]["model"].items():
        assert torch.equal(v, fits[1]["state"]["model"][k]), k


def test_checkpoint_loads_into_one_process_state_bitwise(ranks):
    final = ranks["ranks"][0]["fit"]["state"]
    model = copy.deepcopy(fit_template()).train()
    target = make_train_state(model, total_steps=6)
    CheckpointManager(ranks["work"] / "fit_run" / "weights").restore("last", target)
    assert target.step == 6
    for k, v in target.model.state_dict().items():
        assert torch.equal(v, final["model"][k]), k
    assert target.model.moe_level0.experts_w1.shape[0] == 2
    for k, v in target.ema_params.items():
        assert torch.equal(v, final["ema_params"][k]), k
    for k, v in target.opt.state["trace"].items():
        assert torch.equal(v, final["opt_state"]["trace"][k]), k
