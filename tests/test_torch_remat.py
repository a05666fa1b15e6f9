"""YOLO ``remat`` in the port (``models/yolo.py``, ``models/moe_yolo.py``):
the backbone's and the neck's stages recomputed during backward, as JAX's
``nn.remat`` recomputes them.

* YOLO-n and MoE-YOLO-n at 64×128, one train-mode forward and backward
  with ``remat`` on and off from the same weights: the outputs, the loss
  and every gradient bitwise equal; the running statistics moved once
  (bitwise those of ``remat=False``); each stage really run twice with
  ``remat``; the ``state_dict`` keys equal, and a checkpoint saved by one
  mode loads strictly into the other.
* JAX's ``YoloDetector(remat=True)``: its Flax tree converts strictly into
  the port's ``remat=True`` model, whose outputs agree with JAX's within
  slice 1's tolerances (logits 1e-4, boxes 5e-3 px); after a train-mode
  forward and backward (the recompute) the running statistics agree with
  JAX's train-mode apply within ``test_torch_yolo_train.py``'s 2e-5.
* Two gloo ranks (``tests/_torch_rank_worker.py``'s ``remat`` case): one
  YOLO-n step on a 2 × 1 mesh with ``remat=True`` bitwise the same step
  with ``remat=False`` (the recompute repeats BatchNorm's all-reduce).

Torch runs two intra-op threads (pytest workers run side by side).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import detection_batches, load_flax, numpy_variables
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.losses.tal import yolo_loss
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector, moe_yolo_loss
from multimodal_moe_torch.models.yolo import YoloDetector, count_params
from multimodal_moe_torch.parallel.distributed import run_ranks
from multimodal_moe_tpu.models import yolo as jy

H, W = 64, 128
WORKER = Path(__file__).with_name("_torch_rank_worker.py")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _make(family: str, remat: bool):
    gen = torch.Generator().manual_seed(3)
    if family == "yolo":
        return YoloDetector(num_classes=1, variant="n", remat=remat, generator=gen), yolo_loss
    return (MoEYoloDetector(num_classes=1, variant="n", num_experts=2, remat=remat,
                            generator=gen), moe_yolo_loss)


def _step(family: str, remat: bool):
    """One train-mode forward and backward; the outputs, the loss, the
    gradients, the state after it and how often each stage ran."""
    model, loss_fn = _make(family, remat)
    model.train()
    batch = detection_batches(1, H, W, b=2, seed=5)[0]
    images = torch.from_numpy(batch["image"]).float() / 255.0
    calls = {}
    stages = [(f"{part}.{n}", m) for part in ("backbone", "neck")
              for n, m in getattr(model, part).named_children()]
    for name, mod in stages:
        # A pre-hook: the recompute stops once it has what backward needs
        # (checkpoint's early stop), before a forward hook would run.
        mod.register_forward_pre_hook(lambda m, a, n=name: calls.__setitem__(n, calls.get(n, 0) + 1))
    kw = {"context_ids": torch.tensor([1, 4])} if family == "moe" else {}
    out = model(images, train=True, **kw)
    total, _ = loss_fn(out, torch.from_numpy(batch["gt_labels"]),
                       torch.from_numpy(batch["gt_boxes"]), torch.from_numpy(batch["gt_mask"]))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
    return {"out": {k: v.detach() for k, v in out.items()}, "loss": total.detach(),
            "grads": dict(zip(names, grads)), "state": model.state_dict(), "calls": calls,
            "model": model}


@pytest.fixture(scope="module", params=["yolo", "moe"])
def steps(request):
    return request.param, _step(request.param, False), _step(request.param, True)


def test_outputs_loss_and_gradients_bitwise(steps):
    _, off, on = steps
    assert set(on["out"]) == set(off["out"])
    for k, v in off["out"].items():
        assert torch.equal(on["out"][k], v), k
    assert torch.equal(on["loss"], off["loss"])
    assert set(on["grads"]) == set(off["grads"])
    assert any(float(g.abs().max()) > 0 for g in off["grads"].values())
    for k, g in off["grads"].items():
        assert torch.equal(on["grads"][k], g), k


def test_running_statistics_move_once(steps):
    _, off, on = steps
    running = [k for k in off["state"] if k.endswith(("running_mean", "running_var"))]
    assert running
    fresh = _make("yolo", False)[0].state_dict()
    moved = [k for k in running if k in fresh and not torch.equal(off["state"][k], fresh[k])]
    assert moved, "the train-mode forward moved no running statistic"
    for k in running:
        assert torch.equal(on["state"][k], off["state"][k]), k


def test_each_stage_recomputed(steps):
    _, off, on = steps
    assert off["calls"] and set(off["calls"].values()) == {1}
    assert set(on["calls"]) == set(off["calls"]) and set(on["calls"].values()) == {2}


def test_checkpoints_interchange(steps, tmp_path):
    family, off, on = steps
    assert list(on["state"]) == list(off["state"])
    assert count_params(on["model"]) == count_params(off["model"]) > 0
    for src, remat in ((off, True), (on, False)):
        path = tmp_path / f"{family}_{remat}.pt"
        torch.save(src["state"], path)
        target = _make(family, remat)[0]
        target.load_state_dict(torch.load(path, weights_only=True), strict=True)
        for k, v in target.state_dict().items():
            assert torch.equal(v, src["state"][k]), k


def test_count_params_counts_trainable_elements():
    model = _make("yolo", False)[0]
    total = sum(p.numel() for p in model.parameters())
    assert count_params(model) == total
    model.head.cls0_pred.weight.requires_grad_(False)
    assert count_params(model) == total - model.head.cls0_pred.weight.numel()


def test_jax_remat_model_matches():
    images = np.random.default_rng(4).uniform(0.0, 1.0, (2, H, W, 3)).astype(np.float32)
    jmodel = jy.YoloDetector(num_classes=1, variant="n", remat=True)
    variables = numpy_variables(jmodel, jnp.zeros((1, H, W, 3)), train=False, seed=5)
    for i in range(3):
        variables["params"]["head"][f"cls{i}_pred"]["bias"][:] = -4.6
    ref = jax.device_get(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(images)))
    _, new_vars = jax.device_get(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images)))
    model = load_flax(YoloDetector(num_classes=1, variant="n", remat=True), variables)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    for k in ("box_logits", "cls_logits"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], rtol=0, atol=5e-3)
    # A train-mode forward that recomputes: the running statistics it leaves
    # against Flax's within test_torch_yolo_train.py's 2e-5.
    model.train()
    model(torch.from_numpy(images), train=True)["cls_logits"].sum().backward()
    want = flax_to_state_dict({"params": variables["params"], **new_vars})
    running = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert running
    for k in running:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)


def test_two_ranks_remat_equals_no_remat(tmp_path):
    batch = detection_batches(1, H, W, b=4, seed=8)[0]
    cfg = dict(variant="n", img_h=H, img_w=W, epochs=2, batch=4)
    torch.save({"cfg": cfg, "batch": batch}, tmp_path / "remat_in.pt")
    run_ranks([sys.executable, str(WORKER), "remat", str(tmp_path)], 2,
              env={"OMP_NUM_THREADS": "2"}, timeout=300)
    for r in range(2):
        got = torch.load(tmp_path / f"remat_rank{r}.pt", weights_only=False)
        off, on = got[False], got[True]
        assert on["metrics"] == off["metrics"]
        flat_off, flat_on = _flatten(off["state"]), _flatten(on["state"])
        assert set(flat_on) == set(flat_off)
        traces = [k for k in flat_off if "trace" in k]
        assert traces and any(float(flat_off[k].abs().max()) > 0 for k in traces)
        for k, v in flat_off.items():
            assert torch.equal(flat_on[k], v), k


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif torch.is_tensor(v):
            out[f"{prefix}{k}"] = v
    return out
