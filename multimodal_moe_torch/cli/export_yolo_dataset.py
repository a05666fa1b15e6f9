"""Export the train/val/test splits to the Ultralytics/YOLO layout.

The counterpart of the JAX package's ``scripts/export_yolo_dataset.py``:
``images/<split>`` symlinks, ``labels/<split>/*.txt`` and ``dataset.yaml``
(``data/exports.py``), which ``train_yolo --data-yaml`` reads. Host code
only.

    python -m multimodal_moe_torch.cli.export_yolo_dataset --parquet P --splits-dir S --out-dir D
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths
from ..data.exports import export_yolo_split, write_yolo_dataset_yaml
from ..data.index import load_split_frames


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export YOLO dataset from parquet+splits.")
    p.add_argument("--parquet", type=str, default=str(paths.ZODMOE_FRAMES_WITH_BOXES_PARQUET))
    p.add_argument("--splits-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--out-dir", type=str,
                   default=str(paths.EXPORTS_DIR / "yolo" / "pedestrian_v1_exclude_unclear"))
    p.add_argument("--unclear-policy", choices=["keep_all", "exclude_unclear"],
                   default="exclude_unclear")
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    splits_dir = Path(args.splits_dir)
    for split in args.splits:
        frames = load_split_frames(args.parquet, splits_dir / f"{split}_ids.csv")
        summary = export_yolo_split(split_name=split, frames_df=frames,
                                    out_dataset_dir=args.out_dir,
                                    unclear_policy=args.unclear_policy)
        print(summary)
    yaml_path = write_yolo_dataset_yaml(args.out_dir, {0: "pedestrian"})
    print(f"Wrote {yaml_path}")


if __name__ == "__main__":
    main()
