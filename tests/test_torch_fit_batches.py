"""``DetectionTrainer.fit`` takes every batch form the loaders give, as
JAX's ``fit`` does (through ``prefetch_to_device``), on the CPU.

* Plane batches (``y``/``cb``/``cr`` uint8, a ``store="yuv420"`` loader's)
  train exactly as the same batches with ``image`` made by JAX's
  ``yuv420_to_rgb_u8``: equal histories and equal parameters, bit for bit
  (the conversion is bitwise equal, and the rest of the step is the same
  arithmetic on the same inputs). Before the repair, ``fit`` copied only
  the five step keys and the step raised ``KeyError: 'image'``.
* A batch of tensors already on the trainer's device (the resident
  loader's) reaches ``train_step`` untouched: the same tensor objects.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import detection_batches
from multimodal_moe_torch.train import detection as td
from multimodal_moe_tpu.ops.preprocess import yuv420_to_rgb_u8 as jax_yuv420_to_rgb_u8
from test_torch_train import H, W, _ToyDetector, _toy_loss


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _plane_batches(n=3, b=2, seed=11):
    """``detection_batches``' targets with seeded 4:2:0 planes in place of
    ``image``, and ``batch_valid`` as a loader yields it."""
    rng = np.random.default_rng(seed)
    out = []
    for batch in detection_batches(n, H, W, b=b, seed=seed):
        del batch["image"]
        batch["y"] = rng.integers(0, 256, (b, H, W), dtype=np.uint8)
        batch["cb"] = rng.integers(0, 256, (b, H // 2, W // 2), dtype=np.uint8)
        batch["cr"] = rng.integers(0, 256, (b, H // 2, W // 2), dtype=np.uint8)
        batch["batch_valid"] = np.ones(b, bool)
        out.append(batch)
    return out


def _trainer():
    torch.manual_seed(0)
    cfg = td.DetTrainConfig(variant="r50vd", img_h=H, img_w=W, epochs=2, batch=2, lr0=1e-2,
                            lrf=1.0, optimizer="adamw", weight_decay=1e-4, warmup_epochs=0.0)
    return td.DetectionTrainer(_ToyDetector(), cfg, loss_fn=_toy_loss,
                               device=torch.device("cpu"))


def _strip_wall(summary):
    return {k: v for k, v in summary.items() if k != "train_wall_time_s"}


def test_fit_trains_on_plane_batches_as_on_images(tmp_path):
    planes = _plane_batches()
    converted = []
    for batch in planes:
        rgb = np.asarray(jax.jit(jax_yuv420_to_rgb_u8)(batch["y"], batch["cb"], batch["cr"]))
        converted.append({**{k: v for k, v in batch.items() if k not in ("y", "cb", "cr")},
                          "image": rgb})
    state_p, sum_p = _trainer().fit(planes, run_dir=tmp_path / "planes", log_every=1)
    state_i, sum_i = _trainer().fit(converted, run_dir=tmp_path / "images", log_every=1)
    assert sum_p["epochs_run"] == 2 and state_p.step == state_i.step == 6
    assert _strip_wall(sum_p) == _strip_wall(sum_i)
    for (name, p), (_, q) in zip(state_p.model.named_parameters(),
                                 state_i.model.named_parameters()):
        assert torch.equal(p, q), name
    for name in state_p.ema_params:
        assert torch.equal(state_p.ema_params[name], state_i.ema_params[name]), name


def test_fit_passes_device_batches_through(tmp_path):
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in detection_batches(2, H, W, seed=12)]
    for b in batches:
        b["batch_valid"] = np.ones(2, bool)
    trainer = _trainer()
    trainer.cfg.epochs = 1
    seen = []
    step = trainer.train_step

    def recording_step(state, batch, draws=None):
        seen.append(batch)
        return step(state, batch, draws)

    trainer.train_step = recording_step
    trainer.fit(batches, run_dir=tmp_path, log_every=1)
    assert len(seen) == 2
    for got, given in zip(seen, batches):
        assert set(got) == set(td.BATCH_KEYS) & set(given)
        assert all(got[k] is given[k] for k in got)
