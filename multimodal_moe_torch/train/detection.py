"""Detection trainer: the train step, the epoch loop, best/last checkpoints.

Counterpart of ``multimodal_moe_tpu/train/detection.py`` on one device. One
trainer serves every detector family: the model and its loss are injected.
The step is the JAX step written out: ``/255``, ``train_augment``, the
forward in train mode (ground truth and denoising draws for a model with
``denoising_capable``, ``context_ids`` for one with ``context_aware``), the
loss, its gradients, ``TrainState.apply_gradients``. Random draws come from
``torch.Generator``s seeded from ``(seed, step)``; they are not JAX's.
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.augment import train_augment
from .state import CheckpointManager, TrainState, make_train_state

BATCH_KEYS = ("image", "gt_boxes", "gt_labels", "gt_mask", "solar_bin")


@dataclass
class DetTrainConfig:
    """Training configuration; defaults follow the locked protocol (1248×704,
    50 epochs, batch 16, seed 0) as the JAX config does."""

    variant: str = "s"
    num_classes: int = 1
    img_h: int = 704
    img_w: int = 1248
    epochs: int = 50
    patience: int = 100
    batch: int = 16
    seed: int = 0
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    optimizer: str = "sgd"
    dtype: str = "bfloat16"
    use_ema_for_eval: bool = True
    # Protocol-legal augmentation: photometric + horizontal flip only.
    hsv_aug: bool = True
    hflip_prob: float = 0.5


def _fitness(metrics: dict) -> float:
    """Model-selection scalar: 0.1·mAP50 + 0.9·mAP50-95."""
    return 0.1 * metrics.get("map50", 0.0) + 0.9 * metrics.get("map50_95", 0.0)


class DetectionTrainer:
    """``model`` is the template: ``init_state`` trains a copy of it on
    ``device`` (the card unless ``torch.device("cpu")`` is given)."""

    def __init__(self, model: torch.nn.Module, cfg: DetTrainConfig, *,
                 loss_fn: Optional[Callable] = None, steps_per_epoch: Optional[int] = None,
                 device=None):
        if loss_fn is None:
            raise NotImplementedError(
                "the JAX trainer's default loss_fn, yolo_loss, needs losses/tal.py, which "
                "the port does not have yet; pass loss_fn (e.g. rtdetr_loss)"
            )
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.steps_per_epoch = steps_per_epoch

    # -- state ---------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A copy of the template model on the device in train mode, the
        optimizer of the config (schedule over ``steps_per_epoch``) and the
        EMA."""
        spe = self.steps_per_epoch or 100
        model = copy.deepcopy(self.model).to(self.device).train()
        return make_train_state(
            model, lr0=self.cfg.lr0, lrf=self.cfg.lrf, momentum=self.cfg.momentum,
            weight_decay=self.cfg.weight_decay, warmup_steps=int(spe * self.cfg.warmup_epochs),
            total_steps=spe * self.cfg.epochs, optimizer=self.cfg.optimizer,
        )

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """Draws of one step: stream 0 augments, stream 1 denoises."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(((self.cfg.seed + 7919) << 32) + 2 * step + stream)

    # -- step ----------------------------------------------------------------
    def train_step(self, state: TrainState, batch: "Dict[str, torch.Tensor]",
                   draws: "Optional[dict]" = None) -> "tuple[TrainState, Dict[str, torch.Tensor]]":
        """One step on a batch already on the device. ``draws`` replaces the
        step's random numbers (``{"augment": train_augment's draws,
        "denoise": (shift_u, scale_u)}``), for tests that feed JAX's."""
        cfg, model = self.cfg, state.model
        draws = draws or {}
        images = batch["image"].float() / 255.0
        gt_boxes = batch["gt_boxes"]
        if cfg.hsv_aug or cfg.hflip_prob > 0:
            images, gt_boxes = train_augment(
                images, gt_boxes, generator=self._generator(state.step, 0),
                draws=draws.get("augment"), hsv=cfg.hsv_aug, hflip_prob=cfg.hflip_prob)
        extra = {}
        if getattr(model, "context_aware", False) and "solar_bin" in batch:
            extra["context_ids"] = batch["solar_bin"]
        if getattr(model, "denoising_capable", False):
            extra.update(gt_boxes=gt_boxes, gt_mask=batch["gt_mask"],
                         denoise_generator=self._generator(state.step, 1),
                         dn_draws=draws.get("denoise"))
        outputs = model(images, train=True, **extra)
        total, metrics = self.loss_fn(outputs, batch["gt_labels"], gt_boxes, batch["gt_mask"])
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
        state.apply_gradients(dict(zip(names, grads)))
        return state, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    def _to_device(self, batch) -> "Dict[str, torch.Tensor]":
        """A host batch (numpy or CPU tensors) → the five keys on the device,
        copied from pinned memory without blocking the host."""
        out = {}
        for k in BATCH_KEYS:
            if k not in batch:
                continue
            t = torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(batch[k]) else batch[k])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- loop ----------------------------------------------------------------
    def fit(self, train_loader: Iterable, *, run_dir: "str | Path",
            val_fn: Optional[Callable[[TrainState], dict]] = None, log_every: int = 50,
            state: Optional[TrainState] = None, resume: bool = False,
            max_epochs_this_run: Optional[int] = None) -> "tuple[TrainState, dict]":
        cfg = self.cfg
        run_dir = Path(run_dir)
        self.steps_per_epoch = self.steps_per_epoch or len(train_loader)
        ckpt = CheckpointManager(run_dir / "weights")
        if state is None:
            state = self.init_state()

        # Progress beside the checkpoints, so that an interrupted or chunked
        # run continues where it stopped.
        progress_path = run_dir / "fit_progress.json"
        t_start = time.perf_counter()
        best_fitness = -float("inf")
        epochs_without_improvement = 0
        history = []
        start_epoch = 0
        wall_accum = 0.0
        if resume and not ckpt.has("last") and progress_path.exists():
            # Restarting would train from scratch and overwrite weights/best
            # once the reset best-fitness bar is cleared. Refuse.
            prog_epoch = json.loads(progress_path.read_text()).get("epoch")
            raise RuntimeError(
                f"--resume for {run_dir}: fit_progress.json records epoch "
                f"{prog_epoch} but weights/last is missing. Refusing to "
                "silently restart (it would overwrite weights/best). Restore "
                "the checkpoint, or delete fit_progress.json to deliberately "
                "start over."
            )
        if resume and ckpt.has("last"):
            state = ckpt.restore("last", state)
            if progress_path.exists():
                prog = json.loads(progress_path.read_text())
                start_epoch = int(prog["epoch"]) + 1
                best_fitness = float(prog["best_fitness"])
                epochs_without_improvement = int(prog["epochs_without_improvement"])
                history = list(prog.get("history", []))
                wall_accum = float(prog.get("train_wall_s_accum", 0.0))

        epochs_this_run = 0
        stopped_early = False
        for epoch in range(start_epoch, cfg.epochs):
            epoch_metrics: "Dict[str, list]" = {}
            # Reading a metric waits for the device: batch the reads.
            fetch_every = max(1, int(log_every))
            pending: "list[Dict]" = []

            def _flush():
                for md in pending:
                    for k, v in md.items():
                        epoch_metrics.setdefault(k, []).append(float(v))
                pending.clear()

            for batch in train_loader:
                state, metrics = self.train_step(state, self._to_device(batch))
                pending.append(metrics)
                if len(pending) >= fetch_every:
                    _flush()
            _flush()

            row = {k: float(np.mean(v)) for k, v in epoch_metrics.items()}
            row["epoch"] = epoch
            if val_fn is not None:
                val_metrics = val_fn(state)
                row.update({f"val_{k}": v for k, v in val_metrics.items()
                            if isinstance(v, (int, float))})
                fit = _fitness(val_metrics)
            else:
                fit = -float(row.get("loss", np.inf))

            history.append(row)
            ckpt.save_last(state)
            if fit > best_fitness:
                best_fitness = fit
                ckpt.save_best(state)
                epochs_without_improvement = 0
            else:
                epochs_without_improvement += 1
            print(f"epoch {epoch + 1}/{cfg.epochs} "
                  + " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "epoch"))
            progress_path.write_text(json.dumps({
                "epoch": epoch,
                "best_fitness": best_fitness,
                "epochs_without_improvement": epochs_without_improvement,
                "train_wall_s_accum": wall_accum + (time.perf_counter() - t_start),
                "history": history,
            }))
            epochs_this_run += 1
            if epochs_without_improvement > cfg.patience:
                print(f"Early stopping at epoch {epoch + 1} (patience {cfg.patience}).")
                stopped_early = True
                break
            if max_epochs_this_run and epochs_this_run >= max_epochs_this_run:
                print(f"Pausing after {epochs_this_run} epochs this run "
                      "(resume with --resume to continue).")
                break

        wall = wall_accum + (time.perf_counter() - t_start)
        summary = {
            "train_wall_time_s": wall,
            "best_fitness": best_fitness,
            "epochs_run": len(history),
            "history": history,
            "stopped_early": stopped_early,
            "completed": stopped_early or len(history) >= cfg.epochs,
        }
        return state, summary
