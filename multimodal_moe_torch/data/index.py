"""Frame-ID normalization and split-filtered parquet loading.

The port's own copy of ``multimodal_moe_tpu/data/index.py``:

* IDs normalize to 6-digit zero-padded strings ("123" → "000123", "123.0" →
  "000123", whitespace stripped).
* ``load_split_frames`` returns rows **in split-CSV order**, errors on a
  missing ``frame_id`` column, and errors when zero rows match.

pandas (and pyarrow, through ``read_parquet``) is imported where it is used.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable


def normalize_frame_id(value) -> str:
    """Normalize one frame ID to the canonical 6-digit zero-padded string."""
    s = str(value).strip()
    if s.endswith(".0"):
        s = s[:-2]
    return s.zfill(6)


def normalize_frame_id_series(values: Iterable):
    """Normalize an iterable of frame IDs; returns a ``pandas.Series``."""
    import pandas as pd

    return (
        pd.Series(values)
        .astype(str)
        .str.strip()
        .str.replace(r"\.0$", "", regex=True)
        .str.zfill(6)
    )


def load_split_frame_ids(split_csv: "str | Path", frame_id_col: str = "frame_id") -> "list[str]":
    """Load and normalize the frame IDs of one split CSV."""
    import pandas as pd

    split_csv = Path(split_csv)
    if not split_csv.exists():
        raise FileNotFoundError(f"split_csv not found: {split_csv}")
    df = pd.read_csv(split_csv)
    if frame_id_col not in df.columns:
        raise ValueError(
            f"split_csv missing '{frame_id_col}'. Columns: {df.columns.tolist()}"
        )
    return normalize_frame_id_series(df[frame_id_col]).tolist()


def load_split_frames(
    frames_parquet: "str | Path",
    split_csv: "str | Path",
    frame_id_col: str = "frame_id",
    required_columns: "list[str] | None" = None,
):
    """Parquet rows of one split as a ``pandas.DataFrame``, in split-CSV
    order; a split that matches no row is an error."""
    import pandas as pd

    frames_parquet = Path(frames_parquet)
    if not frames_parquet.exists():
        raise FileNotFoundError(f"frames_parquet not found: {frames_parquet}")

    split_ids = load_split_frame_ids(split_csv=split_csv, frame_id_col=frame_id_col)

    columns = None
    if required_columns is not None:
        columns = list(required_columns)
        if frame_id_col not in columns:
            columns = [frame_id_col] + columns

    df = pd.read_parquet(frames_parquet, columns=columns)
    if frame_id_col not in df.columns:
        raise ValueError(
            f"parquet missing '{frame_id_col}'. Columns: {df.columns.tolist()}"
        )

    df[frame_id_col] = normalize_frame_id_series(df[frame_id_col])
    df = df[df[frame_id_col].isin(set(split_ids))].copy()

    order = {fid: i for i, fid in enumerate(split_ids)}
    df["_split_order"] = df[frame_id_col].map(order)
    df = df.sort_values("_split_order").drop(columns=["_split_order"]).reset_index(drop=True)

    if len(df) == 0:
        raise RuntimeError(
            "No rows matched split IDs. Check frame_id formatting and split/parquet alignment."
        )
    return df
