"""Minimal end-to-end data smoke test: dataset → one sample → one batch.

The counterpart of the JAX package's ``scripts/sanity_dataloader.py``, with
its flags, defaults and three printed lines, over the port's
``data/pipeline.py`` (``ZODMoEVisionDataset``, ``DetectionLoader``). Host
code only.

    python -m multimodal_moe_torch.cli.sanity_dataloader --parquet P --split-csv S
"""

from __future__ import annotations

import argparse

from .. import paths


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Dataloader sanity check.")
    p.add_argument(
        "--parquet",
        type=str,
        default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET),
    )
    p.add_argument("--split-csv", type=str, default=str(paths.TRAIN_SPLIT_CSV))
    p.add_argument("--batch", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ..data.pipeline import DetectionLoader, ZODMoEDataConfig, ZODMoEVisionDataset

    args = parse_args(argv)
    ds = ZODMoEVisionDataset(
        ZODMoEDataConfig(frames_parquet=args.parquet, split_csv=args.split_csv)
    )
    print(f"dataset length: {len(ds)}")
    sample = ds.load(0)
    print(f"one sample: image {sample['image'].shape} {sample['image'].dtype}, "
          f"gt_boxes {sample['gt_boxes'].shape}, label {sample['label']}, "
          f"solar_bin {sample['solar_bin']}")
    loader = DetectionLoader(ds, batch_size=args.batch, drop_last=False)
    batch = next(iter(loader))
    print(f"one batch: image {batch['image'].shape}, gt_mask sum "
          f"{int(batch['gt_mask'].sum())}, valid rows {int(batch['batch_valid'].sum())}")


if __name__ == "__main__":
    main()
