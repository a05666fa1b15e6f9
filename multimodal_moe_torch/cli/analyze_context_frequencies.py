"""Frequency table of the MoE routing context fields.

The counterpart of the JAX package's ``scripts/analyze_context_frequencies.py``:
counts and fractions of weather / time of day / road type / road condition
/ solar bin (fields that would leak the label are left out) →
``context_field_frequencies.csv``, and a bar-panel plot where matplotlib
is installed (else it prints that it skipped the plot). Host code only.

    python -m multimodal_moe_torch.cli.analyze_context_frequencies --parquet P --out-dir D
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths

CONTEXT_FIELDS = [
    "scraped_weather",
    "time_of_day",
    "road_type",
    "road_condition",
    "solar_context_bin",
]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Analyze context-field frequencies.")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--out-dir", type=str, default=str(paths.ANALYSIS_DIR / "context"))
    return p.parse_args(argv)


def build_frequency_table(df) -> "list[dict]":
    rows = []
    for field in CONTEXT_FIELDS:
        if field not in df.columns:
            continue
        counts = df[field].fillna("missing").astype(str).value_counts()
        total = counts.sum()
        for value, count in counts.items():
            rows.append({"field": field, "value": value, "count": int(count),
                         "fraction": float(count / total)})
    return rows


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    df = pd.read_parquet(args.parquet)
    table = pd.DataFrame(build_frequency_table(df))
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "context_field_frequencies.csv"
    table.to_csv(csv_path, index=False)
    print(f"Wrote {csv_path}")
    print(table.to_string(index=False))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fields = [f for f in CONTEXT_FIELDS if f in table["field"].unique()]
        fig, axes = plt.subplots(1, len(fields), figsize=(4 * len(fields), 4))
        if len(fields) == 1:
            axes = [axes]
        for ax, field in zip(axes, fields):
            sub = table[table["field"] == field]
            ax.bar(sub["value"], sub["fraction"])
            ax.set_title(field, fontsize=9)
            ax.tick_params(axis="x", rotation=45, labelsize=7)
        fig.tight_layout()
        plot_path = out_dir / "context_field_frequencies.png"
        fig.savefig(plot_path, dpi=120, bbox_inches="tight")
        print(f"Wrote {plot_path}")
    except ImportError:
        print("matplotlib unavailable; skipped plot")


if __name__ == "__main__":
    main()
