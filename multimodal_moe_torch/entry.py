"""Entry points: the flagship detector's forward at the protocol
resolution, and one training step of the context-routed MoE detector over
a mesh of ranks.

Counterpart of ``entry()`` and ``dryrun_multichip()`` in the repository's
``__graft_entry__.py``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from ._device import resolve_device
from .models.yolo import YoloDetector

IMG_H, IMG_W = 704, 1248


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(images_u8)`` runs YOLO-s (random
    weights from seed 0) on a uint8 NHWC batch and returns
    ``(boxes (B, A, 4), scores (B, A))``. Runs on ``cuda`` unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    model = YoloDetector(num_classes=1, variant="s", generator=gen).eval().to(dev)

    def fn(images_u8):
        with torch.inference_mode():
            out = model(images_u8.float() / 255.0)
            return out["boxes"], torch.sigmoid(out["cls_logits"][..., 0])

    example_args = (torch.zeros((1, IMG_H, IMG_W, 3), dtype=torch.uint8, device=dev),)
    return fn, example_args


def dryrun_batch(b: int, h: int = 64, w: int = 128) -> dict:
    """``dryrun_multichip``'s global batch (JAX's: seeded noise frames, one
    ground-truth box a frame, a solar bin a frame)."""
    rng = np.random.default_rng(0)
    m = 8
    gt_boxes = np.zeros((b, m, 4), np.float32)
    gt_boxes[:, 0] = [10, 10, 50, 40]
    gt_mask = np.zeros((b, m), bool)
    gt_mask[:, 0] = True
    return {"image": rng.integers(0, 255, (b, h, w, 3)).astype(np.uint8),
            "gt_boxes": gt_boxes, "gt_labels": np.zeros((b, m), np.int32),
            "gt_mask": gt_mask, "solar_bin": (np.arange(b) % 6).astype(np.int32)}


def dryrun_model(num_expert: int):
    """The dry run's model: MoE-YOLO-n on ``dispatch="sweep"`` with
    ``max(num_expert, 2)`` experts, random weights from seed 0."""
    from .models.moe_yolo import MoEYoloDetector

    return MoEYoloDetector(num_classes=1, variant="n", num_experts=max(num_expert, 2),
                           dispatch="sweep", generator=torch.Generator().manual_seed(0))


def dryrun_multichip(n_devices: int, backend=None, device=None, save_to=None) -> dict:
    """One training step of MoE-YOLO-n on ``dispatch="sweep"`` at 64×128
    over ``n_devices`` ranks on a ``(n/2 data × 2 expert)`` mesh (1 expert
    when ``n`` is odd), each rank a process of this host: the batch split
    over both axes, the expert weights over the expert axis. Prints JAX's
    line (``dryrun_multichip ok: mesh=… step=… loss=… moe_aux=…
    dispatch=sweep``) and returns rank 0's numbers.

    The ranks run on the card unless ``device="cpu"``. ``backend=None`` is
    ``nccl`` on the card and ``gloo`` on the CPU; NCCL takes one rank a
    card, so with ``nccl`` the step runs on ``min(n_devices, cards)`` ranks
    (the returned ``ranks`` says how many). ``save_to`` (a file) receives
    rank 0's record: the state after the step in the one-process layout,
    the metrics and each MoE level's router logits over the global batch.
    """
    cuda = resolve_device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    ranks = min(n_devices, torch.cuda.device_count()) if backend == "nccl" else n_devices
    from .parallel.distributed import run_ranks

    root = str(Path(__file__).resolve().parents[1])
    args = json.dumps([backend, None if device is None else str(device),
                       None if save_to is None else str(save_to)])
    code = (f"import sys, json; sys.path.insert(0, {root!r}); "
            f"from multimodal_moe_torch.entry import _dryrun_rank; "
            f"_dryrun_rank(*json.loads({args!r}))")
    results = run_ranks([sys.executable, "-c", code], ranks, timeout=900)
    lines = results[0][1].strip().splitlines()
    print(lines[-2], flush=True)
    return {**json.loads(lines[-1]), "ranks": ranks, "backend": backend}


def _dryrun_rank(backend, device, save_to) -> None:
    """One rank of :func:`dryrun_multichip`."""
    from .models.moe_yolo import moe_yolo_loss
    from .parallel.distributed import loader_shard, maybe_initialize_distributed, rank_device
    from .parallel.mesh import batch_slice, create_mesh
    from .train.detection import DetectionTrainer, DetTrainConfig
    from .train.state import one_process_state_dict

    import torch.distributed as dist

    maybe_initialize_distributed(backend=backend, device=device)
    rank, world = loader_shard()
    dev = rank_device(device)
    num_expert = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = create_mesh(num_expert=num_expert)
    h, w, b = 64, 128, max(world, 2)
    model = dryrun_model(num_expert)
    cfg = DetTrainConfig(variant="n", img_h=h, img_w=w, epochs=1, batch=b)
    trainer = DetectionTrainer(model, cfg, loss_fn=moe_yolo_loss, mesh=mesh, steps_per_epoch=1,
                               device=dev)
    state = trainer.init_state()
    rows = batch_slice(mesh, b)
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in dryrun_batch(b, h, w).items()}
    logits = {}
    hooks = [getattr(state.model, f"moe_level{i}").router.register_forward_hook(
        lambda mod, args, out, i=i: logits.__setitem__(i, out.detach()))
        for i in range(3)] if save_to else []
    state, metrics = trainer.train_step(state, batch)
    for hk in hooks:
        hk.remove()
    loss = float(metrics["loss"])
    aux = float(metrics.get("moe_aux_loss", 0.0))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if save_to:
        record = {"state": one_process_state_dict(state, mesh),
                  "metrics": {k: v.cpu() for k, v in metrics.items()},
                  "router_logits": {i: mesh.gather(v).cpu() for i, v in logits.items()}}
        if rank == 0:
            torch.save(record, save_to)
    if rank == 0:
        print(f"dryrun_multichip ok: mesh={mesh.shape} step={state.step} "
              f"loss={loss:.4f} moe_aux={aux:.4f} dispatch=sweep")
        print(json.dumps({"mesh": mesh.shape, "step": state.step, "loss": loss,
                          "moe_aux_loss": aux}), flush=True)
    dist.destroy_process_group()
