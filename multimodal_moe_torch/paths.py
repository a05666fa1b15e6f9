"""Env-var-overridable path registry.

The port's own copy of ``multimodal_moe_tpu/paths.py``: the same constant
names, the same environment variables (each constant is overridden by the
variable of its name) and the same defaults. ``PROJECT_ROOT`` is the
repository root, so both packages read and write the same ``outputs/``
tree. The CLIs in ``cli/`` take their default paths from here.
"""

from __future__ import annotations

import os
from pathlib import Path


def _get_path(env_var: str, default: "str | Path") -> Path:
    """Resolve a path from the environment with a fallback default."""
    return Path(os.environ.get(env_var, str(default))).expanduser().resolve()


# --- Dataset roots -----------------------------------------------------------
# Source-of-truth data root (resized images + split CSVs live under it).
ZOD_MOE_DATA = _get_path("ZOD_MOE_DATA", "~/zod_moe")
# Raw ZOD frames root (one dir per frame: metadata.json, annotations/, camera_front_dnat/).
ZOD_ROOT = _get_path("ZOD_ROOT", "~/zod_dino_data/train2017")
RESIZED_IMAGES_DIR = _get_path("RESIZED_IMAGES_DIR", ZOD_MOE_DATA / "resized_images")
SPLITS_DIR = _get_path("SPLITS_DIR", ZOD_MOE_DATA / "splits")
TRAIN_SPLIT_CSV = _get_path("TRAIN_SPLIT_CSV", SPLITS_DIR / "train_ids.csv")
VAL_SPLIT_CSV = _get_path("VAL_SPLIT_CSV", SPLITS_DIR / "val_ids.csv")
TEST_SPLIT_CSV = _get_path("TEST_SPLIT_CSV", SPLITS_DIR / "test_ids.csv")

# --- Project output tree -----------------------------------------------------
PROJECT_ROOT = Path(__file__).resolve().parents[1]
OUTPUTS_DIR = _get_path("OUTPUTS_DIR", PROJECT_ROOT / "outputs")
INDEX_DIR = _get_path("INDEX_DIR", OUTPUTS_DIR / "index")
EXPORTS_DIR = _get_path("EXPORTS_DIR", OUTPUTS_DIR / "exports")
RUNS_DIR = _get_path("RUNS_DIR", OUTPUTS_DIR / "runs")
EVAL_DIR = _get_path("EVAL_DIR", OUTPUTS_DIR / "eval")
ANALYSIS_DIR = _get_path("ANALYSIS_DIR", OUTPUTS_DIR / "analysis")
PLOTS_DIR = _get_path("PLOTS_DIR", OUTPUTS_DIR / "plots")

# --- Canonical parquet tables -------------------------------------------------
ZODMOE_FRAMES_PARQUET = _get_path(
    "ZODMOE_FRAMES_PARQUET", INDEX_DIR / "ZODmoe_frames.parquet"
)
ZODMOE_FRAMES_WITH_BOXES_PARQUET = _get_path(
    "ZODMOE_FRAMES_WITH_BOXES_PARQUET",
    INDEX_DIR / "ZODmoe_frames_with_xyxy_bboxes.parquet",
)
ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET = _get_path(
    "ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET",
    INDEX_DIR / "ZODmoe_frames_with_xyxy_bboxes_and_solar_bins.parquet",
)


def describe_paths() -> "dict[str, dict]":
    """Status report of every registered path."""
    out = {}
    for name, value in sorted(globals().items()):
        if isinstance(value, Path) and name.isupper():
            out[name] = {
                "path": str(value),
                "exists": value.exists(),
                "is_dir": value.is_dir(),
                "is_file": value.is_file(),
            }
    return out
