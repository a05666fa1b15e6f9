"""The classification baseline, the port against JAX on the CPU: the vanilla
ResNet (``models/resnet.py``: 7×7 stem, strided 1×1 shortcut, mean pool,
``Dense`` head) and ``cli/train_vision_baseline.py`` against
``scripts/train_vision_baseline.py``.

* ``resnet18`` (width 16) and ``resnet50`` (full width) with 2 classes on
  numpy weights (Flax variables made at ``jax.eval_shape``'s shapes, every
  BatchNorm randomised: no init compile), 64×64, B=2: eval-mode logits
  rtol/atol 1e-4 (tests/test_torch_resnet.py's; JAX applied eagerly), and
  train-mode logits with the batch statistics JAX's ``mutable`` returns,
  rtol/atol 5e-4: train mode normalises by Flax's fast variance
  E[x²] − E[x]², whose float32 cancellation turns the frameworks' summation
  orders into larger differences, the more so over ResNet-50's 53
  BatchNorms and its last stage's 8 values a channel (measured 4.1e-4; the
  train-mode tolerance of tests/test_torch_rtdetr_train.py).
* The vd backbone is what it was: the class's defaults are the r50vd
  trunk's, stage maps only.
* One step of the CLI's ``train_step`` (the small classifier, 32×32, B=4)
  against the script's step (``optax.adamw(1e-4)``, softmax cross-entropy
  over ImageNet-normalised images, jitted): the accuracy equal and the
  loss within 1e-4 (train-mode BatchNorm again, on maps of 1–16 values a
  channel: measured 4.8e-5);
  the optimizer fed JAX's own gradients within 1e-6 of each parameter's
  norm (optax's arithmetic); after the port's own step every element
  within 2·lr of JAX's (Adam's first update is lr·g/(|g| + ε), so a
  gradient near 0 may take either sign: train-mode BatchNorm's float32
  gradients differ by ~1e-2 relative between the frameworks,
  tests/test_torch_rtdetr_train.py), the mean difference within 0.1·lr.
* The CLI's flags and defaults equal the script's ``parse_args()``'s,
  read in process (the script is never run: its JAX step would compile).
* The CLI in process on the data tests' synthetic corpus at 32×32: the
  same subset of frames as JAX's dataset and permutation, two epochs of
  finite loss and accuracy lines, the plot written or skipped.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_data import write_corpus
from _torch_parity import load_flax, nchw, numpy_variables
from multimodal_moe_torch.cli import train_vision_baseline as cli
from multimodal_moe_torch.convert import flax_to_state_dict
from multimodal_moe_torch.models import resnet as tr
from multimodal_moe_tpu.models import resnet as jr

REPO = Path(__file__).resolve().parents[1]
TOL, TRAIN_TOL = 1e-4, 5e-4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def pair(name: str, hw, seed: int, **kw):
    """JAX's and the port's ``name`` with 2 classes on the same numpy
    weights."""
    jmodel = getattr(jr, name)(num_classes=2, **kw)
    variables = numpy_variables(jmodel, jnp.zeros((1, *hw, 3)), train=False, seed=seed)
    tmodel = load_flax(getattr(tr, name)(num_classes=2, **kw), variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("name,kw", [("resnet18", {"width": 16}), ("resnet50", {})],
                         ids=["resnet18", "resnet50"])
def test_vanilla_resnet_matches_jax(name, kw):
    hw = (64, 64)
    images = np.random.default_rng(5).uniform(-1.5, 1.5, (2, *hw, 3)).astype(np.float32)
    jmodel, variables, tmodel = pair(name, hw, seed=7, **kw)
    assert tmodel._ConvBN_0.Conv_0.kernel_size == (7, 7)
    assert not hasattr(tmodel, "_ConvBN_1")
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(images), train=False))
    with torch.no_grad():
        got = tmodel(nchw(images)).numpy()
    assert got.shape == ref.shape == (2, 2)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)

    ref, mutated = jmodel.apply(variables, jnp.asarray(images), train=True,
                                mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(nchw(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TRAIN_TOL, atol=TRAIN_TOL)
    want = flax_to_state_dict({"batch_stats": jax.device_get(mutated["batch_stats"])})
    have = tmodel.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(have[k].numpy(), v.numpy(), rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                       err_msg=k)


def test_vd_backbone_mode_unchanged():
    """The class's defaults build the r50vd trunk RT-DETR loads: the deep
    stem, the pooled shortcut, no head, the four stage maps."""
    torch.manual_seed(0)
    model = tr.ResNet(stage_sizes=(1, 1, 1, 1), width=16).eval()
    same = tr.ResNet(stage_sizes=(1, 1, 1, 1), width=16, num_classes=None, vd=True).eval()
    same.load_state_dict(model.state_dict(), strict=True)
    assert [n for n, _ in model.named_children()][:3] == ["_ConvBN_0", "_ConvBN_1", "_ConvBN_2"]
    assert not hasattr(model, "Dense_0") and model.BottleneckBlock_1.pool
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        maps, again = model(x), same(x)
    assert [m.shape[1] for m in maps] == model.out_channels
    for a, b in zip(maps, again):
        assert torch.equal(a, b)


def jax_step(jmodel, variables, images_u8, labels):
    """The script's ``train_step`` (jitted; eager takes a minute): loss,
    acc, grads, new params."""
    tx = optax.adamw(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    @jax.jit
    def step(params, batch_stats, opt_state, images_u8, labels):
        images = images_u8.astype(jnp.float32) / 255.0
        images = (images - jnp.asarray([0.485, 0.456, 0.406])) / jnp.asarray([0.229, 0.224, 0.225])

        def loss_fn(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, images,
                                     train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        acc = (jnp.argmax(logits, -1) == labels).mean()
        return loss, acc, grads, optax.apply_updates(params, updates)

    loss, acc, grads, new = jax.device_get(step(params, batch_stats, tx.init(params),
                                                jnp.asarray(images_u8), labels))
    return float(loss), float(acc), grads, new


def test_adamw_step_matches_optax():
    hw, b = (32, 32), 4
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (b, *hw, 3)).astype(np.uint8)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel, variables, _ = pair("resnet18", hw, seed=8, width=16)
    loss, acc, grads, new = jax_step(jmodel, variables, images, jnp.asarray(labels))
    want = flax_to_state_dict({"params": new})

    # The optimizer on JAX's gradients: optax's arithmetic.
    model = load_flax(tr.resnet18(num_classes=2, width=16), variables).train()
    cli.make_adamw(model, LR).step(flax_to_state_dict({"params": grads}))
    for k, p in model.named_parameters():
        assert (p.detach() - want[k]).norm() <= 1e-6 * want[k].norm(), k

    # The CLI's own step.
    model = load_flax(tr.resnet18(num_classes=2, width=16), variables).train()
    got_loss, got_acc = cli.train_step(model, cli.make_adamw(model, LR), torch.from_numpy(images),
                                       torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-4)
    assert float(got_acc) == acc
    moved = 0
    for k, p in model.named_parameters():
        d = (p.detach() - want[k]).abs()
        assert float(d.max()) <= 2 * LR + 1e-6, (k, float(d.max()))
        assert float(d.mean()) <= 0.1 * LR, (k, float(d.mean()))
        moved += int(not torch.equal(p.detach(), flax_to_state_dict(variables)[k]))
    assert moved == len(want)


def jax_script():
    """``scripts/train_vision_baseline.py`` as a module (never run)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location("jax_train_vision_baseline",
                                                      REPO / "scripts" / "train_vision_baseline.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.mark.parametrize("argv", [[], ["--epochs", "2", "--batch", "8", "--lr", "3e-4",
                                       "--subset", "10", "--img-size", "32", "--seed", "4",
                                       "--workers", "1", "--plot-path", "p.png",
                                       "--parquet", "f.parquet", "--split-csv", "s.csv"]],
                         ids=["defaults", "every-flag"])
def test_flags_and_defaults_match_script(monkeypatch, argv):
    monkeypatch.setenv("MMOE_XLA_CACHE", "")
    monkeypatch.delenv("MMOE_PLATFORM", raising=False)
    script = jax_script()
    monkeypatch.setattr(sys, "argv", ["train_vision_baseline.py", *argv])
    assert vars(cli.parse_args(argv)) == vars(script.parse_args())


def test_cli_runs_on_the_synthetic_corpus(tmp_path, monkeypatch, capsys):
    from multimodal_moe_torch.data import pipeline
    from multimodal_moe_tpu.data.pipeline import ZODMoEDataConfig, ZODMoEVisionDataset

    corpus = write_corpus(tmp_path / "corpus", 14, seed=2)
    monkeypatch.setenv("MMOE_PLATFORM", "cpu")
    seen = []
    real = pipeline.DetectionLoader

    def loader(ds, **kw):
        seen.append((list(ds.df["frame_id"]), kw))
        return real(ds, **kw)

    monkeypatch.setattr(pipeline, "DetectionLoader", loader)
    plot = tmp_path / "plots" / "acc.png"
    cli.main(["--parquet", str(corpus["parquet"]), "--split-csv", str(corpus["train"]),
              "--epochs", "2", "--batch", "4", "--subset", "9", "--img-size", "32",
              "--seed", "3", "--workers", "1", "--plot-path", str(plot)])
    out = capsys.readouterr().out

    ds = ZODMoEVisionDataset(ZODMoEDataConfig(frames_parquet=str(corpus["parquet"]),
                                              split_csv=str(corpus["train"]), img_h=32, img_w=32,
                                              max_boxes=1))
    pick = np.random.default_rng(3).permutation(len(ds))[:9]
    (frames, kw), = seen
    assert frames == list(ds.df["frame_id"].iloc[pick])
    assert kw["drop_last"] and kw["shuffle"] and kw["batch_size"] == 4
    lines = re.findall(r"epoch (\d)/2 loss=(\S+) acc=(\S+)", out)
    assert [n for n, _, _ in lines] == ["1", "2"]
    assert all(np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0 for _, loss, acc in lines)
    assert "train wall time:" in out
    assert (f"Saved plot -> {plot}" in out and plot.exists()) or "skipped plot" in out
