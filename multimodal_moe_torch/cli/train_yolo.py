"""Train the YOLO detector on the card.

The counterpart of the JAX package's ``scripts/train_yolo.py``, with its
flags, defaults (704×1248, 50 epochs, patience 100, batch 16, seed 0) and
run dir (``cli/_train.py``): data from the parquet index and split CSVs, or
from an exported Ultralytics layout (``--data-yaml``,
``data/yolo_layout.py``); ``--resident`` keeps the split on the card;
``--remat`` recomputes the trunk's stages during backward.
``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.train_yolo --model yolo-s --name baseline
"""

from __future__ import annotations

import argparse

from ._train import REMAT_HELP, add_run_args


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train YOLO detector.")
    p.add_argument("--model", type=str, default="yolo-s", help="yolo-{n,s,m,l}")
    add_run_args(p, epochs=50, lr0=0.01, project="yolo")
    p.add_argument("--data-yaml", type=str, default=None,
                   help="Train from an exported Ultralytics-layout dataset.yaml instead of "
                   "the parquet index.")
    p.add_argument("--lrf", type=float, default=0.01)
    p.add_argument("--optimizer", choices=["sgd", "adamw"], default="sgd")
    p.add_argument("--eval-every", type=int, default=1, help="Val every N epochs.")
    p.add_argument("--remat", action="store_true", help=REMAT_HELP)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from ..models.yolo import YoloDetector
    from ..train.detection import DetTrainConfig
    from ._train import train

    variant = args.model.split("-")[-1]
    make_ds = None
    if args.data_yaml:
        from ..data.yolo_layout import YoloLayoutConfig, YoloLayoutDataset

        def make_ds(split: str):
            return YoloLayoutDataset(YoloLayoutConfig(
                dataset_yaml=args.data_yaml, split=split, img_h=args.img_h,
                img_w=args.img_w, max_boxes=args.max_boxes))

    cfg = DetTrainConfig(variant=variant, img_h=args.img_h, img_w=args.img_w,
                         epochs=args.epochs, patience=args.patience, batch=args.batch,
                         seed=args.seed, lr0=args.lr0, lrf=args.lrf, optimizer=args.optimizer)
    run_dir = train(
        args, model=YoloDetector(num_classes=1, variant=variant, remat=args.remat), cfg=cfg,
        model_config={"family": "yolo", "variant": variant, "num_classes": 1,
                      "optimizer": args.optimizer, "img_h": args.img_h, "img_w": args.img_w},
        model_name=args.model,
        metadata={"model_family": "yolo", "model_variant": variant},
        make_ds=make_ds, validate=args.eval_every > 0)
    print(f"Weights -> {run_dir / 'weights' / 'best'} (and .../last)")


if __name__ == "__main__":
    main()
