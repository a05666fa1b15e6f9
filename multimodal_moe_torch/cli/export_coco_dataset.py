"""Export the train/val/test splits to the COCO ``instances_{split}.json``
layout.

The counterpart of the JAX package's ``scripts/export_coco_dataset.py``,
with its ``--max-frames-per-split`` cap and ``export_manifest.json``
(``data/exports.py``). Host code only.

    python -m multimodal_moe_torch.cli.export_coco_dataset --parquet P --splits-dir S --out-dir D
"""

from __future__ import annotations

import argparse
import json
from dataclasses import asdict
from pathlib import Path

from .. import paths
from ..data.exports import export_coco_split
from ..data.index import load_split_frames


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export COCO dataset from parquet+splits.")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--splits-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--out-dir", type=str,
                   default=str(paths.EXPORTS_DIR / "coco" / "pedestrian_v1_exclude_unclear"))
    p.add_argument("--unclear-policy", choices=["keep_all", "exclude_unclear"],
                   default="exclude_unclear")
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--max-frames-per-split", type=int, default=None, help="Smoke-test cap.")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    splits_dir = Path(args.splits_dir)
    summaries = []
    for split in args.splits:
        frames = load_split_frames(args.parquet, splits_dir / f"{split}_ids.csv")
        if args.max_frames_per_split is not None:
            frames = frames.iloc[: args.max_frames_per_split].reset_index(drop=True)
        summary = export_coco_split(split_name=split, frames_df=frames,
                                    out_dataset_dir=args.out_dir,
                                    unclear_policy=args.unclear_policy)
        summaries.append(asdict(summary))
        print(summary)

    manifest = {"parquet": str(args.parquet), "unclear_policy": args.unclear_policy,
                "splits": summaries}
    manifest_path = Path(args.out_dir) / "export_manifest.json"
    manifest_path.write_text(json.dumps(manifest, indent=2))
    print(f"Wrote {manifest_path}")


if __name__ == "__main__":
    main()
