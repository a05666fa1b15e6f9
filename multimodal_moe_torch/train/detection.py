"""Detection trainer: the train step, the epoch loop, best/last checkpoints.

Counterpart of ``multimodal_moe_tpu/train/detection.py``. One
trainer serves every detector family: the model and its loss are injected
(the YOLO loss, ``losses.tal.yolo_loss``, unless another is given).
The step is the JAX step written out: ``/255``, ``train_augment``, the
forward in train mode (ground truth and denoising draws for a model with
``denoising_capable``, ``context_ids`` for one with ``context_aware``), the
loss, its gradients, ``TrainState.apply_gradients``. Random draws come from
``torch.Generator``s seeded from ``(seed, step)``; they are not JAX's.
Under a profiler the step is the span ``train.step``, with
``train.augment``, ``train.forward``, ``train.loss``, ``train.backward``
and ``train.update`` (``clip``, ``sgd``, ``ema``: ``train/state.py``)
inside (``utils.profiler.annotate``).

With ``mesh=`` (``parallel.mesh.create_mesh``, one process a rank) the
step computes what the one-process step computes on the global batch, as
JAX's ``jit`` over the mesh does: each rank takes its slice of the batch
and of the global batch's draws; inside ``use_mesh`` the model and the
loss form their batch statistics over every rank, so every rank holds the
global loss ``L``. Each rank differentiates ``L / ranks`` (the first
backward ``all_reduce`` sums the ranks' ``1/ranks`` back to 1, so each
rank's activations get their exact share of ``∂L``), and the gradients are
summed once: replicated tensors over the world group, ``experts_*`` shards
over the data group. Only models whose batch reductions are all global
(``global_batch_reductions``: YOLO, MoE-YOLO, RT-DETR) train on more than
one rank.

Validation inside ``fit`` on a mesh gives every rank the same metrics, as
JAX's ``val_fn`` over the whole split on every process does: every rank
gathers the expert shards of the parameters and the EMA (a collective),
rank 0 runs ``val_fn`` on the one-process state outside ``use_mesh``, and
its numeric metrics are broadcast. Each rank evaluating on its own could
differ in the last bit (cuDNN may pick other algorithms on other cards),
take another branch at ``best_fitness`` and hang in ``save_best``'s
barriers.
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
from ..data.pipeline import prefetch_to_device
from ..losses.tal import yolo_loss
from ..ops.augment import augment_draws, train_augment
from ..parallel.distributed import rank_device
from ..parallel.mesh import (
    Mesh,
    barrier,
    batch_slice,
    broadcast_module,
    broadcast_object,
    gather_params,
    reduce_gradients,
    shard_module,
    use_mesh,
)
from ..utils.profiler import annotate
from .state import CheckpointManager, TrainState, make_train_state

BATCH_KEYS = ("image", "gt_boxes", "gt_labels", "gt_mask", "solar_bin")


def _step_keys(batch: dict) -> dict:
    """The keys ``train_step`` reads (JAX's ``fit`` keeps the same five)."""
    return {k: v for k, v in batch.items() if k in BATCH_KEYS}


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
    ``device`` (the card unless ``torch.device("cpu")`` is given); with
    ``mesh``, the rank's device (``parallel.distributed.rank_device``)."""

    def __init__(self, model: torch.nn.Module, cfg: DetTrainConfig, *,
                 loss_fn: Callable = yolo_loss, mesh: "Optional[Mesh]" = None,
                 steps_per_epoch: Optional[int] = None, device=None):
        if mesh is not None and mesh.size > 1 and not getattr(
                model, "global_batch_reductions", False):
            raise NotImplementedError(
                f"{type(model).__name__} does not train on a mesh of {mesh.size} ranks: it "
                "does not declare global_batch_reductions, so some of its batch reductions "
                "could be per rank")
        self.device = rank_device(device) if mesh is not None else resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.steps_per_epoch = steps_per_epoch

    # -- state ---------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A copy of the template model on the device in train mode, the
        optimizer of the config (schedule over ``steps_per_epoch``) and the
        EMA. On a mesh every rank takes rank 0's copy, then keeps its expert
        shards (the EMA's too)."""
        spe = self.steps_per_epoch or 100
        model = copy.deepcopy(self.model).to(self.device).train()
        if self.mesh is not None and self.mesh.world_group is not None:
            shard_module(broadcast_module(model, self.mesh), self.mesh)
        return make_train_state(
            model, mesh=self.mesh, lr0=self.cfg.lr0, lrf=self.cfg.lrf, momentum=self.cfg.momentum,
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
        """One step on a batch already on the device (on a mesh, this rank's
        slice of the global batch). ``draws`` replaces the step's random
        numbers (``{"augment": train_augment's draws, "denoise": (shift_u,
        scale_u)}``, for the global batch), for tests that feed JAX's."""
        cfg, model, mesh = self.cfg, state.model, self.mesh
        draws = draws or {}
        with annotate("train.step"):
            with annotate("train.augment"):
                images = batch["image"].float() / 255.0
                gt_boxes = batch["gt_boxes"]
                if cfg.hsv_aug or cfg.hflip_prob > 0:
                    aug = draws.get("augment")
                    if mesh is not None:   # the global batch's draws, this rank's rows
                        rows = batch_slice(mesh, images.shape[0] * mesh.size)
                        if aug is None:
                            aug = augment_draws(images.shape[0] * mesh.size,
                                                self._generator(state.step, 0), images.device,
                                                hflip_prob=cfg.hflip_prob)
                        aug = {k: v[rows] for k, v in aug.items()}
                    images, gt_boxes = train_augment(
                        images, gt_boxes, generator=self._generator(state.step, 0),
                        draws=aug, hsv=cfg.hsv_aug, hflip_prob=cfg.hflip_prob)
            extra = {}
            if getattr(model, "context_aware", False) and "solar_bin" in batch:
                extra["context_ids"] = batch["solar_bin"]
            if getattr(model, "denoising_capable", False):
                dn = draws.get("denoise")
                if mesh is not None and dn is not None:   # the global batch's, this rank's rows
                    rows = batch_slice(mesh, dn[0].shape[0])
                    dn = tuple(d[rows] for d in dn)
                extra.update(gt_boxes=gt_boxes, gt_mask=batch["gt_mask"],
                             denoise_generator=self._generator(state.step, 1), dn_draws=dn)
            with use_mesh(mesh):
                with annotate("train.forward"):
                    outputs = model(images, train=True, **extra)
                with annotate("train.loss"):
                    total, metrics = self.loss_fn(outputs, batch["gt_labels"], gt_boxes,
                                                  batch["gt_mask"])
                names, params = zip(*model.named_parameters())
                objective = total / mesh.size if mesh is not None else total
                with annotate("train.backward"):
                    grads = torch.autograd.grad(objective, params, allow_unused=True,
                                                materialize_grads=True)
            grads = dict(zip(names, grads))
            if mesh is not None:
                grads = reduce_gradients(grads, mesh)
            with annotate("train.update"):
                state.apply_gradients(grads)
            return state, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    def _to_device(self, batch) -> "Dict[str, torch.Tensor]":
        """One batch through ``prefetch_to_device``, cut to the step's keys
        (on a mesh, this rank's rows of a global batch)."""
        (out,) = prefetch_to_device(iter([batch]), device=self.device, buffer_size=1,
                                    mesh=self.mesh)
        return _step_keys(out)

    # -- validation ----------------------------------------------------------
    def validate(self, val_fn: Callable[[TrainState], dict], state: TrainState) -> dict:
        """``val_fn(state)``; on a mesh of more than one rank the same
        numeric metrics on every rank: every rank gathers the expert shards
        of the parameters, running statistics and EMA (a collective), rank 0
        evaluates them in a one-process copy of the template and broadcasts
        the metrics."""
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return val_fn(state)
        full = state
        if mesh.num_expert > 1:
            model_sd = gather_params(state.model.state_dict(), mesh)
            ema = gather_params(state.ema_params, mesh)
            if mesh.rank == 0:
                model = copy.deepcopy(self.model).to(self.device)
                model.load_state_dict(model_sd, strict=True)
                full = TrainState(step=state.step, model=model.train(state.model.training),
                                  opt=state.opt, ema_params=ema)
        metrics = None
        if mesh.rank == 0:
            metrics = {k: v for k, v in val_fn(full).items() if isinstance(v, (int, float))}
        return broadcast_object(metrics, mesh)

    # -- loop ----------------------------------------------------------------
    def fit(self, train_loader: Iterable, *, run_dir: "str | Path",
            val_fn: Optional[Callable[[TrainState], dict]] = None, log_every: int = 50,
            state: Optional[TrainState] = None, resume: bool = False,
            max_epochs_this_run: Optional[int] = None) -> "tuple[TrainState, dict]":
        cfg = self.cfg
        run_dir = Path(run_dir)
        self.steps_per_epoch = self.steps_per_epoch or len(train_loader)
        ckpt = CheckpointManager(run_dir / "weights", mesh=self.mesh)
        # On a mesh every rank saves (the expert shards are gathered) and
        # reads the progress file; rank 0 alone writes files and logs. The
        # metrics are global, so every rank takes the same branches.
        is_lead = self.mesh is None or self.mesh.rank == 0
        shard = (getattr(train_loader, "process_index", 0),
                 getattr(train_loader, "process_count", 1))
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

            # Host batches (RGB, or YUV420 planes that become ``image`` on
            # the device) are copied ahead of the step; the resident
            # loader's device batches pass through untouched.
            for batch in prefetch_to_device(iter(train_loader), device=self.device,
                                            mesh=self.mesh, shard=shard):
                state, metrics = self.train_step(state, _step_keys(batch))
                pending.append(metrics)
                if len(pending) >= fetch_every:
                    _flush()
            _flush()

            row = {k: float(np.mean(v)) for k, v in epoch_metrics.items()}
            row["epoch"] = epoch
            if val_fn is not None:
                val_metrics = self.validate(val_fn, state)
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
            if is_lead:
                print(f"epoch {epoch + 1}/{cfg.epochs} "
                      + " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "epoch"))
                progress_path.write_text(json.dumps({
                    "epoch": epoch,
                    "best_fitness": best_fitness,
                    "epochs_without_improvement": epochs_without_improvement,
                    "train_wall_s_accum": wall_accum + (time.perf_counter() - t_start),
                    "history": history,
                }))
            barrier(self.mesh)
            epochs_this_run += 1
            if epochs_without_improvement > cfg.patience:
                if is_lead:
                    print(f"Early stopping at epoch {epoch + 1} (patience {cfg.patience}).")
                stopped_early = True
                break
            if max_epochs_this_run and epochs_this_run >= max_epochs_this_run:
                if is_lead:
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
