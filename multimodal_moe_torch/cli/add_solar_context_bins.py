"""Add the binned solar-elevation context labels (the MoE routing signal).

The counterpart of the JAX package's ``scripts/add_solar_context_bins.py``,
over ``data/solar.py``: the input parquet is never overwritten, and an
existing output needs ``--overwrite``. Host code only.

    python -m multimodal_moe_torch.cli.add_solar_context_bins --in-parquet P --out-parquet Q
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths
from ..data.solar import add_solar_context_bins


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Add solar context bins and save derived parquet.")
    p.add_argument("--in-parquet", type=str, default=str(paths.ZODMOE_FRAMES_WITH_BOXES_PARQUET))
    p.add_argument("--out-parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--overwrite", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    in_parquet = Path(args.in_parquet).expanduser().resolve()
    out_parquet = Path(args.out_parquet).expanduser().resolve()

    if not in_parquet.exists():
        raise FileNotFoundError(f"Input parquet not found: {in_parquet}")
    if out_parquet.exists() and not args.overwrite:
        raise FileExistsError(
            f"Output parquet already exists: {out_parquet}. Use --overwrite to replace it.")

    df = add_solar_context_bins(pd.read_parquet(in_parquet))
    out_parquet.parent.mkdir(parents=True, exist_ok=True)
    df.to_parquet(out_parquet, index=False)

    print(f"Input parquet  -> {in_parquet}")
    print(f"Output parquet -> {out_parquet}")
    print("solar_context_bin counts:")
    print(df["solar_context_bin"].value_counts(dropna=False).to_string())


if __name__ == "__main__":
    main()
