"""Run the index data-QA battery and write a markdown and a JSON report.

The counterpart of the JAX package's ``scripts/analyze_index_qa.py``
(``data/qa.py``): ``qa_report.json`` and ``qa_report.md`` in ``--out-dir``,
exit code 1 when a hard invariant fails, so it can gate an ingestion run.
One difference, for a host without matplotlib: ``--plots`` there prints
that it skipped the plot. Host code only.

    python -m multimodal_moe_torch.cli.analyze_index_qa --parquet P --out-dir QA
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..data import qa
from ..paths import OUTPUTS_DIR


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Index data-QA report.")
    ap.add_argument("--parquet", type=Path, default=OUTPUTS_DIR / "index" / "ZODmoe_frames.parquet")
    ap.add_argument("--out-dir", type=Path, default=OUTPUTS_DIR / "qa")
    ap.add_argument("--plots", action="store_true", help="Also write histogram PNGs.")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import pandas as pd

    args = parse_args(argv)
    df = pd.read_parquet(args.parquet)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    try:
        report = qa.run_full_qa(df)
        ok = True
    except AssertionError as e:
        print(f"QA FAILED: {e}", file=sys.stderr)
        report = {"error": str(e)}
        ok = False

    (args.out_dir / "qa_report.json").write_text(json.dumps(report, indent=2, default=str))

    lines = [f"# Index QA report — {args.parquet.name}", ""]
    if ok:
        lab = report["labels"]
        lines += [
            f"- frames: **{lab['n_frames']}**, ped_present rate {lab['ped_present_rate']:.3f}",
            f"- clear/unclear pedestrians: {lab['total_clear_peds']} / {lab['total_unclear_peds']}",
            f"- ped_bin_4: {lab['ped_bin_4_counts']}",
            f"- parallel-array invariant: **{report['parallel_array_violations']} violations**",
            f"- occlusion column mismatches: {report['occlusion']['n_mismatched_frames']}",
            f"- missing values: {report['missing_values'] or 'none'}",
        ]
        if report["bboxes"].get("n_boxes"):
            bb = report["bboxes"]
            lines += [
                f"- boxes: {bb['n_boxes']}, height p50 {bb['height_px']['p50']:.1f}px",
                f"- visibility at min heights: {bb['visible_fraction_at_min_height']}",
            ]
        for col, tab in qa.context_crosstabs(df).items():
            lines += ["", f"## ped_bin_4 × {col}", "", tab.to_markdown()]
    else:
        lines.append(f"**QA FAILED**: {report['error']}")
    (args.out_dir / "qa_report.md").write_text("\n".join(lines) + "\n")

    if args.plots and ok:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 2, figsize=(10, 4))
            df["ped_count_clear"].hist(ax=axes[0], bins=30)
            axes[0].set_title("ped_count_clear per frame")
            df["ped_bin_4"].value_counts().sort_index().plot.bar(ax=axes[1])
            axes[1].set_title("ped_bin_4")
            fig.tight_layout()
            fig.savefig(args.out_dir / "qa_histograms.png", dpi=100)
        except ImportError:
            print("matplotlib unavailable; skipped plot")

    print(f"QA {'OK' if ok else 'FAILED'} -> {args.out_dir}/qa_report.md")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
