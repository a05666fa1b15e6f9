"""Solar-elevation context bins: the routing signal of the MoE detector.

The port's own copy of the parts of ``multimodal_moe_tpu/data/solar.py``
that the loaders and the router read: right-closed intervals over
``(-inf, -6], (-6, 0], (0, 15], (15, 45], (45, inf)`` labelled
night/twilight/low_sun/mid_sun/high_sun, ``"missing"`` for absent values,
and their integer ids. The ingestion half (``add_solar_context_bins``,
``solar_bin_labels``) is not ported. pandas is imported where it is used.
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


def solar_bin_one_hot(bin_ids: np.ndarray) -> np.ndarray:
    """Integer bin ids → ``(N, NUM_SOLAR_BINS)`` float32 one-hot (router input)."""
    return np.eye(NUM_SOLAR_BINS, dtype=np.float32)[np.asarray(bin_ids, dtype=np.int64)]
