"""Index data-QA battery: label distributions, missing values, the
parallel-array invariant, occlusion consistency, context crosstabs and box
sizes in the resized frame.

The port's own copy of ``multimodal_moe_tpu/data/qa.py``: every function
gives JAX's result on the same frame (``tests/test_torch_ingest_modules.py``);
``cli/analyze_index_qa.py`` writes it as a report. The functions take a
``pandas.DataFrame``; pandas itself is imported where it is used.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

OCC_COLUMNS = [
    "ped_occ_none", "ped_occ_light", "ped_occ_medium",
    "ped_occ_heavy", "ped_occ_veryheavy", "ped_occ_missing", "ped_occ_unknown",
]
BIN_LABELS = {0: "0", 1: "1-5", 2: "6-15", 3: ">15"}


def label_distributions(df) -> Dict[str, Any]:
    """Pedestrian count / bin / presence distributions."""
    bins = df["ped_bin_4"].value_counts().sort_index()
    return {
        "n_frames": int(len(df)),
        "ped_count_clear": df["ped_count_clear"].describe().to_dict(),
        "ped_count_unclear": df["ped_count_unclear"].describe().to_dict(),
        "ped_bin_4_counts": {BIN_LABELS.get(int(k), str(k)): int(v) for k, v in bins.items()},
        "ped_present_rate": float(df["ped_present"].mean()),
        "total_clear_peds": int(df["ped_count_clear"].sum()),
        "total_unclear_peds": int(df["ped_count_unclear"].sum()),
    }


def missing_values(df):
    """Per-column missing-value counts (a ``pandas.Series``)."""
    return df.isna().sum()


def parallel_array_invariant(df):
    """The per-frame parallel-array invariant: ``ped_uuid``,
    ``ped_unclear_list``, ``ped_occlusion_list`` and
    ``ped_points_xy_resized`` each hold ped_count_clear + ped_count_unclear
    entries. Returns the offending rows (empty frame == healthy index)."""
    def row_ok(r) -> bool:
        n = int(r["ped_count_clear"]) + int(r["ped_count_unclear"])
        return (
            len(r["ped_uuid"]) == n
            and len(r["ped_unclear_list"]) == n
            and len(r["ped_occlusion_list"]) == n
            and len(r["ped_points_xy_resized"]) == n
        )

    bad = df[~df.apply(row_ok, axis=1)]
    return bad[["frame_id", "ped_count_clear", "ped_count_unclear"]] if len(bad) else bad


def occlusion_consistency(df) -> Dict[str, Any]:
    """The occlusion-count columns sum to each frame's pedestrian count;
    and the occlusion levels that 'unclear' pedestrians carry."""
    occ_sum = df[OCC_COLUMNS].sum(axis=1)
    total = df["ped_count_clear"] + df["ped_count_unclear"]
    mismatched = df[occ_sum != total]

    per_level: Dict[str, int] = {c: int(df[c].sum()) for c in OCC_COLUMNS}
    unclear_levels: Dict[str, int] = {}
    for _, r in df.iterrows():
        for unclear, level in zip(r["ped_unclear_list"], r["ped_occlusion_list"]):
            if unclear:
                unclear_levels[level] = unclear_levels.get(level, 0) + 1
    return {
        "n_mismatched_frames": int(len(mismatched)),
        "mismatched_frame_ids": mismatched["frame_id"].tolist()[:20],
        "occlusion_totals": per_level,
        "unclear_ped_occlusion_levels": unclear_levels,
    }


def context_crosstabs(df) -> Dict[str, Any]:
    """ped_bin_4 crosstabs (``pandas.DataFrame``) by time of day, weather
    and road type."""
    import pandas as pd

    out = {}
    for col in ["time_of_day", "scraped_weather", "road_type"]:
        if col in df.columns:
            out[col] = pd.crosstab(df["ped_bin_4"], df[col])
    return out


def bbox_stats(df, *, min_heights=(8, 12, 16, 24, 32)) -> Dict[str, Any]:
    """Pedestrian box sizes in the resized frame, and the fraction that
    stays at least k px high at 1248×704. Reads ``xyxy_bboxes`` where the
    box stage has run, else rebuilds boxes from ``ped_points_xy_resized``."""
    heights, widths, areas = [], [], []
    for _, r in df.iterrows():
        boxes = r.get("xyxy_bboxes", None)
        if boxes is None or (hasattr(boxes, "__len__") and len(boxes) == 0):
            boxes = []
            for pts in r["ped_points_xy_resized"]:
                # Parquet gives nested lists back as object arrays of (2,)
                # arrays; stack takes those and plain lists alike.
                pts = (
                    np.stack([np.asarray(p, dtype=np.float64) for p in pts])
                    if len(pts)
                    else np.zeros((0, 2))
                ).reshape(-1, 2)
                if pts.size == 0:
                    continue
                boxes.append(
                    [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
                )
        boxes_arr = (
            np.stack([np.asarray(b, dtype=np.float64).reshape(4) for b in boxes])
            if len(boxes)
            else np.zeros((0, 4))
        )
        for b in boxes_arr:
            w, h = float(b[2] - b[0]), float(b[3] - b[1])
            if w <= 0 or h <= 0:
                continue
            widths.append(w)
            heights.append(h)
            areas.append(w * h)
    heights_arr = np.asarray(heights)
    out: Dict[str, Any] = {
        "n_boxes": int(heights_arr.size),
        "height_px": {
            k: float(v)
            for k, v in zip(
                ["mean", "p10", "p50", "p90", "max"],
                [heights_arr.mean(), *np.percentile(heights_arr, [10, 50, 90]), heights_arr.max()],
            )
        }
        if heights_arr.size
        else {},
        "width_px_p50": float(np.median(widths)) if widths else None,
        "area_px_p50": float(np.median(areas)) if areas else None,
    }
    if heights_arr.size:
        out["visible_fraction_at_min_height"] = {
            f">={k}px": float((heights_arr >= k).mean()) for k in min_heights
        }
    return out


def run_full_qa(df) -> Dict[str, Any]:
    """The full battery; raises AssertionError on any hard invariant
    violation."""
    report: Dict[str, Any] = {"labels": label_distributions(df)}
    bad = parallel_array_invariant(df)
    report["parallel_array_violations"] = int(len(bad))
    occ = occlusion_consistency(df)
    report["occlusion"] = occ
    report["missing_values"] = {
        k: int(v) for k, v in missing_values(df).items() if v > 0
    }
    report["bboxes"] = bbox_stats(df)
    assert len(bad) == 0, f"parallel-array invariant violated on {len(bad)} frames"
    assert occ["n_mismatched_frames"] == 0, "occlusion columns don't sum to ped totals"
    return report
