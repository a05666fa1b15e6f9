"""Aggregate per-run eval artifacts into benchmark comparison tables + plots.

The counterpart of the JAX package's ``scripts/report_detector_benchmarks.py``,
with its flags, defaults, printed lines and files: it walks
``EVAL_DIR/<family>/<run>/`` (the port's ``paths.EVAL_DIR``, where
``cli/eval_detector.py`` writes), merges run_metadata + train_summary +
metrics per run, standardizes metric keys, and writes

* ``baseline_runs_aggregated.csv``
* ``speed_vs_accuracy_table.csv``
* ``precision_recall_operating_points.csv``
* plots: speed-vs-accuracy scatter, PR operating points, PR-curve overlay
  (where matplotlib is missing it prints that it skipped them)

Host code only.

    python -m multimodal_moe_torch.cli.report_detector_benchmarks --eval-dir E --out-dir O
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import paths

STANDARD_KEYS = [
    "map50",
    "map50_95",
    "precision",
    "recall",
    "speed_preprocess_ms_per_img",
    "speed_inference_ms_per_img",
    "speed_postprocess_ms_per_img",
    "speed_total_ms_per_img",
    "fps_inference_only",
    "fps_end_to_end",
    "params_total",
    "flops_g",
]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Aggregate detector benchmark runs.")
    p.add_argument("--eval-dir", type=str, default=str(paths.EVAL_DIR))
    p.add_argument(
        "--out-dir", type=str, default=str(paths.ANALYSIS_DIR / "benchmarks")
    )
    return p.parse_args(argv)


def _read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def collect_rows(eval_dir: Path) -> "tuple[list[dict], list[dict]]":
    """One row per run; plus PR-curve payloads for the overlay plot."""
    rows, curves = [], []
    for family_dir in sorted(p for p in eval_dir.iterdir() if p.is_dir()):
        for run_dir in sorted(p for p in family_dir.iterdir() if p.is_dir()):
            metrics = _read_json(run_dir / "metrics.json")
            metadata = _read_json(run_dir / "run_metadata.json")
            summary = _read_json(run_dir / "train_summary.json")
            if not metrics and not metadata:
                continue
            row = {
                "family": family_dir.name,
                "run": run_dir.name,
                "model_variant": metadata.get("model_variant"),
                "split": metadata.get("split"),
                "img_h": metadata.get("img_h"),
                "img_w": metadata.get("img_w"),
                "seed": metadata.get("seed"),
                "train_wall_time_s": summary.get("train_wall_time_s"),
            }
            for k in STANDARD_KEYS:
                row[k] = metrics.get(k)
            rows.append(row)
            for curve in metrics.get("curves_results", []):
                if curve.get("name", "").startswith("Precision-Recall"):
                    curves.append(
                        {"label": f"{family_dir.name}/{run_dir.name}", **curve}
                    )
    return rows, curves


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    eval_dir = Path(args.eval_dir)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if not eval_dir.exists():
        raise FileNotFoundError(f"eval dir not found: {eval_dir}")
    rows, curves = collect_rows(eval_dir)
    if not rows:
        print(f"No runs found under {eval_dir}")
        return

    df = pd.DataFrame(rows)
    agg_path = out_dir / "baseline_runs_aggregated.csv"
    df.to_csv(agg_path, index=False)

    speed_cols = [
        "family", "run", "model_variant", "params_total",
        "speed_inference_ms_per_img", "fps_inference_only", "fps_end_to_end",
        "map50", "map50_95",
    ]
    speed_path = out_dir / "speed_vs_accuracy_table.csv"
    df[[c for c in speed_cols if c in df.columns]].to_csv(speed_path, index=False)

    pr_path = out_dir / "precision_recall_operating_points.csv"
    df[["family", "run", "precision", "recall", "map50"]].to_csv(pr_path, index=False)

    print(f"Wrote {agg_path}")
    print(f"Wrote {speed_path}")
    print(f"Wrote {pr_path}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # speed vs accuracy
        fig, ax = plt.subplots(figsize=(7, 5))
        d = df.dropna(subset=["fps_end_to_end", "map50_95"])
        for fam, grp in d.groupby("family"):
            ax.scatter(grp["fps_end_to_end"], grp["map50_95"], label=fam, s=60)
            for _, r in grp.iterrows():
                ax.annotate(r["run"], (r["fps_end_to_end"], r["map50_95"]), fontsize=7)
        ax.set_xlabel("FPS (end-to-end)")
        ax.set_ylabel("mAP50-95")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.savefig(out_dir / "speed_vs_accuracy.png", dpi=120, bbox_inches="tight")

        # PR operating points
        fig, ax = plt.subplots(figsize=(6, 6))
        d = df.dropna(subset=["precision", "recall"])
        for fam, grp in d.groupby("family"):
            ax.scatter(grp["recall"], grp["precision"], label=fam, s=60)
        ax.set_xlabel("recall")
        ax.set_ylabel("precision")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.savefig(
            out_dir / "precision_recall_points.png", dpi=120, bbox_inches="tight"
        )

        # PR curve overlay
        if curves:
            fig, ax = plt.subplots(figsize=(7, 6))
            for c in curves:
                ax.plot(c["x"], c["y"], label=c["label"])
            ax.set_xlabel("recall")
            ax.set_ylabel("precision")
            ax.legend(fontsize=7)
            ax.grid(True, alpha=0.3)
            fig.savefig(out_dir / "pr_curve_overlay.png", dpi=120, bbox_inches="tight")
        print(f"Wrote plots under {out_dir}")
    except ImportError:
        print("matplotlib unavailable; skipped plots")


if __name__ == "__main__":
    main()
