"""Solar-elevation context bins: the routing signal of the MoE detector.

The port's own copy of ``multimodal_moe_tpu/data/solar.py``: right-closed
intervals over
``(-inf, -6], (-6, 0], (0, 15], (15, 45], (45, inf)`` labelled
night/twilight/low_sun/mid_sun/high_sun, ``"missing"`` for absent values,
their integer ids, and the ingestion stage that writes the labels into the
parquet (``solar_bin_labels``, ``add_solar_context_bins``). pandas is
imported where it is used.
"""

from __future__ import annotations

import numpy as np

SOLAR_BIN_EDGES = [-1e9, -6.0, 0.0, 15.0, 45.0, 1e9]
SOLAR_BIN_LABELS = [
    "night(<-6)",
    "twilight(-6..0)",
    "low_sun(0..15)",
    "mid_sun(15..45)",
    "high_sun(>45)",
]
MISSING_LABEL = "missing"
# Integer ids: the 5 real bins in SOLAR_BIN_LABELS order, then "missing".
NUM_SOLAR_BINS = len(SOLAR_BIN_LABELS) + 1
SOLAR_BIN_TO_ID = {label: i for i, label in enumerate(SOLAR_BIN_LABELS)}
SOLAR_BIN_TO_ID[MISSING_LABEL] = len(SOLAR_BIN_LABELS)


def solar_bin_ids(solar_elevation) -> np.ndarray:
    """Vectorized elevation (degrees) → integer bin id (missing/NaN → last id)."""
    import pandas as pd

    x = np.asarray(pd.to_numeric(pd.Series(solar_elevation), errors="coerce"), dtype=np.float64)
    # right-closed bins as pd.cut(right=True): x <= -6 → 0, -6 < x <= 0 → 1, ...
    ids = np.digitize(x, SOLAR_BIN_EDGES[1:-1], right=True)
    ids = np.where(np.isnan(x), len(SOLAR_BIN_LABELS), ids)
    return ids.astype(np.int32)


def solar_bin_labels(solar_elevation):
    """Vectorized elevation (degrees) → string label ``pandas.Series``
    (``"string"`` dtype)."""
    import pandas as pd

    ids = solar_bin_ids(solar_elevation)
    all_labels = np.asarray(SOLAR_BIN_LABELS + [MISSING_LABEL], dtype=object)
    return pd.Series(all_labels[ids]).astype("string")


def add_solar_context_bins(df, out_col: str = "solar_context_bin"):
    """A copy of ``df`` with the solar bin label column added; ``df`` needs
    a ``solar_angle_elevation`` column."""
    if "solar_angle_elevation" not in df.columns:
        raise ValueError("Expected 'solar_angle_elevation' column in input parquet.")
    out = df.copy()
    labels = solar_bin_labels(out["solar_angle_elevation"])
    labels.index = out.index
    out[out_col] = labels
    return out


def solar_bin_one_hot(bin_ids: np.ndarray) -> np.ndarray:
    """Integer bin ids → ``(N, NUM_SOLAR_BINS)`` float32 one-hot (router input)."""
    return np.eye(NUM_SOLAR_BINS, dtype=np.float32)[np.asarray(bin_ids, dtype=np.int64)]
