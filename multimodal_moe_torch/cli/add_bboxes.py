"""Add the canonical xyxy pedestrian boxes to the frame parquet.

The counterpart of the JAX package's ``scripts/add_bboxes.py``: each
pedestrian's multipoint → xyxy, clamped, kept where at least 2 px a side
(``data/indexer.add_xyxy_bboxes``). Host code only.

    python -m multimodal_moe_torch.cli.add_bboxes --in-parquet P --out-parquet Q
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths
from ..data.indexer import add_xyxy_bboxes


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Add xyxy bbox column to parquet.")
    p.add_argument("--in-parquet", type=str, default=str(paths.ZODMOE_FRAMES_PARQUET))
    p.add_argument("--out-parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_PARQUET))
    return p.parse_args(argv)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    df = add_xyxy_bboxes(pd.read_parquet(args.in_parquet))
    Path(args.out_parquet).parent.mkdir(parents=True, exist_ok=True)
    df.to_parquet(args.out_parquet)
    print(f"Saved updated parquet to: {args.out_parquet}")


if __name__ == "__main__":
    main()
