"""Classification sanity baseline: ResNet-50 from scratch on ``ped_present``,
on the card.

The counterpart of the JAX package's ``scripts/train_vision_baseline.py``,
with its flags, defaults and output: the 2-class vanilla ResNet-50
(``models.resnet.resnet50(num_classes=2)``, weights from ``--seed``), a
random subset of ``--subset`` frames chosen by
``np.random.default_rng(seed).permutation`` (the same frames as JAX's), the
port's ``DetectionLoader`` (``drop_last=True``, ``batch["label"]``),
ImageNet mean/std normalisation, softmax cross-entropy, per-epoch
``loss``/``acc`` lines, the wall time, and the accuracy curve to
``--plot-path`` (skipped where matplotlib is missing).

The optimizer is ``optax.adamw(lr)``'s: a constant rate from the first
step, weight decay 1e-4 on every parameter (no mask) and no clip, built
from the port's ``train.state.Optimizer`` (every parameter decayed,
``grad_clip_norm=None``, its ``schedule`` replaced by a constant).
``MMOE_PLATFORM=cpu`` runs on the CPU.

On a multi-process launch (``parallel.distributed``'s variables) the ranks
form a data mesh (``create_mesh()``): rank 0's weights are broadcast, each
rank's loader yields its strided shard of the epoch order, ``--batch``
frames a rank, and the global batch is the ranks' batches in rank order,
as ``cli/_train.py`` and ``prefetch_to_device`` give them meaning. The
BatchNorms normalise with the global batch's statistics (``use_mesh``),
the loss and the accuracy are means over the global batch, and the
gradients are summed once over the ranks (``reduce_gradients``) before
AdamW, so every rank takes the same step. An epoch has as many steps as
the smallest shard gives. Only rank 0 writes the plot. (JAX's script puts
each process's local batch on the mesh with ``jax.device_put``, which
gives no well-defined global batch on more than one process.)

    python -m multimodal_moe_torch.cli.train_vision_baseline --parquet P --split-csv S
"""

from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path

from .. import paths

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
WEIGHT_DECAY = 1e-4   # optax.adamw's default


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train ped_present ResNet baseline.")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--split-csv", type=str, default=str(paths.TRAIN_SPLIT_CSV))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--subset", type=int, default=2048)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--plot-path", type=str,
                   default=str(paths.PLOTS_DIR / "train_acc_ped_present.png"))
    return p.parse_args(argv)


def make_adamw(model, lr: float):
    """``optax.adamw(lr)`` over ``model``'s parameters: constant ``lr``,
    every parameter decayed by 1e-4, no clip."""
    from ..train.state import Optimizer

    params = dict(model.named_parameters())
    opt = Optimizer(params, {k: True for k in params}, optimizer="adamw",
                    weight_decay=WEIGHT_DECAY, grad_clip_norm=None)
    opt.schedule = lambda count: lr
    return opt


def loss_and_grads(model, images_u8, labels, mesh=None):
    """The mean softmax cross-entropy and accuracy of a batch on the model's
    device (``/255``, ImageNet normalisation, the train-mode forward), and
    the gradients of the loss. On a mesh the batch is this rank's slice of
    the global batch: the BatchNorms use the global statistics, the loss
    and the accuracy are the global batch's means, and the gradients are
    those of the global loss (each rank differentiates its rows' share,
    summed over the ranks). Returns (loss, accuracy, gradients by name)."""
    import torch
    import torch.nn.functional as F

    from ..parallel.mesh import reduce_gradients, use_mesh

    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    images = ((images_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    count = labels.shape[0] * (mesh.size if mesh is not None else 1)   # --batch rows a rank
    with use_mesh(mesh):
        logits = model(images)
    loss = F.cross_entropy(logits, labels.long(), reduction="sum") / count
    sums = torch.stack([loss.detach(), (logits.argmax(-1) == labels).float().sum()])
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    if mesh is not None:
        grads = reduce_gradients(grads, mesh)
        sums = mesh.all_reduce(sums)
    return sums[0], sums[1] / count, grads


def train_step(model, opt, images_u8, labels, mesh=None):
    """One step on a batch on the model's device: :func:`loss_and_grads`,
    then the AdamW update. Returns the loss and accuracy (tensors)."""
    loss, acc, grads = loss_and_grads(model, images_u8, labels, mesh)
    opt.step(grads)
    return loss, acc


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from ..data.pipeline import DetectionLoader, ZODMoEDataConfig, ZODMoEVisionDataset
    from ..models.resnet import resnet50
    from ..parallel.distributed import loader_shard, maybe_initialize_distributed, rank_device
    from ..parallel.mesh import broadcast_module, create_mesh
    from ._common import platform_device

    maybe_initialize_distributed(device=platform_device())
    proc_idx, proc_count = loader_shard()
    device = rank_device(platform_device())

    ds = ZODMoEVisionDataset(ZODMoEDataConfig(
        frames_parquet=args.parquet, split_csv=args.split_csv, img_h=args.img_size,
        img_w=args.img_size, max_boxes=1))
    # Random subset like the reference.
    rng = np.random.default_rng(args.seed)
    subset = min(args.subset, len(ds))
    ds.df = ds.df.iloc[rng.permutation(len(ds))[:subset]].reset_index(drop=True)
    loader = DetectionLoader(ds, batch_size=args.batch, shuffle=True, seed=args.seed,
                             process_index=proc_idx, process_count=proc_count,
                             num_workers=args.workers, drop_last=True)
    # Every rank takes the same number of steps: the smallest shard's.
    steps = (len(ds) // proc_count) // args.batch

    model = resnet50(num_classes=2, generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).train()
    mesh = create_mesh() if proc_count > 1 else None
    if mesh is not None:
        broadcast_module(model, mesh)
    opt = make_adamw(model, args.lr)

    accs = []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        sums, n = [], 0
        for batch in itertools.islice(loader, steps):
            images = torch.from_numpy(batch["image"]).to(device, non_blocking=True)
            labels = torch.from_numpy(batch["label"]).to(device, non_blocking=True)
            sums.append(torch.stack(train_step(model, opt, images, labels, mesh)))
            n += 1
        loss, acc = torch.stack(sums).double().sum(0).tolist() if sums else (0.0, 0.0)
        accs.append(acc / max(n, 1))
        print(f"epoch {epoch + 1}/{args.epochs} loss={loss / max(n, 1):.4f} "
              f"acc={accs[-1]:.4f}")
    wall = time.perf_counter() - t0
    print(f"train wall time: {wall:.1f}s")

    if proc_idx != 0:   # rank 0 writes the plot
        return
    # Accuracy curve.
    plot_path = Path(args.plot_path)
    plot_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(6, 4))
        plt.plot(range(1, len(accs) + 1), accs, marker="o")
        plt.xlabel("epoch")
        plt.ylabel("train accuracy")
        plt.title("ped_present baseline (ResNet-50, from scratch)")
        plt.grid(True, alpha=0.3)
        plt.savefig(plot_path, dpi=120, bbox_inches="tight")
        print(f"Saved plot -> {plot_path}")
    except ImportError:
        print("matplotlib unavailable; skipped plot")


if __name__ == "__main__":
    main()
