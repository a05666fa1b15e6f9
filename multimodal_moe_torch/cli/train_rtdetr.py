"""Train the RT-DETR detector on the card.

The counterpart of the JAX package's ``scripts/train_rtdetr.py``: its flags
and defaults (72 epochs, AdamW at a flat 1e-4 with weight decay 1e-4 and
one warm-up epoch, ``--remat`` on by default) and the run dir of
``cli/_train.py``; the loss is ``detr_loss`` at the run's image size, and
validation takes the NMS-free top-k tail. The deformable attention runs
through its hand-written kernels (B4 forward, B5 backward) on the card.
RT-DETR does not train on more than one rank yet (the trainer raises).
``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.train_rtdetr --name baseline
"""

from __future__ import annotations

import argparse
import functools

from ._train import add_run_args


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train RT-DETR.")
    add_run_args(p, epochs=72, lr0=1e-4, project="rtdetr")
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--num-queries", type=int, default=300)
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                   help="Recompute backbone blocks in the backward pass (more forward "
                   "work for multi-GB activation savings at protocol resolution).")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from ..models.rtdetr import RTDETRDetector, rtdetr_loss
    from ..train.detection import DetTrainConfig
    from ._train import train

    model = RTDETRDetector(num_classes=1, hidden_dim=args.hidden_dim,
                           num_queries=args.num_queries,
                           num_decoder_layers=args.decoder_layers, remat=args.remat)
    cfg = DetTrainConfig(variant="r50vd", img_h=args.img_h, img_w=args.img_w,
                         epochs=args.epochs, patience=args.patience, batch=args.batch,
                         seed=args.seed, lr0=args.lr0,
                         lrf=1.0,  # RT-DETR keeps a flat learning rate with AdamW
                         optimizer="adamw", weight_decay=1e-4, warmup_epochs=1.0)
    train(
        args, model=model, cfg=cfg,
        loss_fn=functools.partial(rtdetr_loss, img_hw=(args.img_h, args.img_w)),
        model_config={"family": "rtdetr", "variant": "r50vd", "num_classes": 1,
                      "hidden_dim": args.hidden_dim, "num_queries": args.num_queries,
                      "num_decoder_layers": args.decoder_layers, "optimizer": "adamw",
                      "img_h": args.img_h, "img_w": args.img_w},
        model_name="rtdetr-r50vd",
        metadata={"model_family": "rtdetr", "model_variant": "r50vd"},
        use_nms=False)


if __name__ == "__main__":
    main()
