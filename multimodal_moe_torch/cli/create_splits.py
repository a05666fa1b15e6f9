"""Create the stratified train/val/test split CSVs.

The counterpart of the JAX package's ``scripts/create_splits.py``: 80/10/10
stratified on ped_bin_4 × time_of_day, seed 0, through ``data/splits.py``'s
numpy split (the same rows in the same order as sklearn's, which JAX's
uses). Host code only.

    python -m multimodal_moe_torch.cli.create_splits --parquet P --output-dir SPLITS
"""

from __future__ import annotations

import argparse

from .. import paths
from ..data.splits import create_stratified_splits, write_split_csvs


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Create stratified splits.")
    p.add_argument("--parquet", type=str, default=str(paths.ZODMOE_FRAMES_PARQUET))
    p.add_argument("--output-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    splits = create_stratified_splits(pd.read_parquet(args.parquet), seed=args.seed)
    write_split_csvs(splits, args.output_dir)
    print(f"Created splits -- train: {len(splits['train'])}, "
          f"val: {len(splits['val'])}, test: {len(splits['test'])}")


if __name__ == "__main__":
    main()
