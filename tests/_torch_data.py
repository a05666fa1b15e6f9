"""Shared corpus for the data-path parity tests (``test_torch_data.py``,
``test_torch_native_decode.py``, ``test_torch_resident.py``): pre-resized
4:2:0 JPEGs, a parquet with the columns the loaders read and split CSVs,
made with numpy from a seed, as ``tests/test_pipeline.py``'s
``presized_corpus`` is."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

H, W = 64, 128
MAX_BOXES = 3
SOLAR = ["night(<-6)", "twilight(-6..0)", "low_sun(0..15)", "mid_sun(15..45)",
         "high_sun(>45)", "missing", "day"]   # "day" is no bin: the last id


def frame(rng, h: int, w: int) -> np.ndarray:
    """A smooth RGB frame with a few figure-sized rectangles."""
    yy = np.linspace(0, 180, h)[:, None]
    xx = np.linspace(0, rng.uniform(30, 90), w)[None, :]
    arr = np.clip(yy + xx + rng.normal(0, 3, (h, w)), 0, 255)
    img = np.stack([arr, 0.7 * arr + 30, 255 - arr], -1)
    for _ in range(3):
        x0, y0 = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 16))
        img[y0 : y0 + 16, x0 : x0 + 8] = rng.integers(0, 256, 3)
    return img.astype(np.uint8)


def write_jpeg(path: Path, img: np.ndarray, subsampling: int = 2) -> None:
    from PIL import Image

    Image.fromarray(img).save(path, quality=92, subsampling=subsampling)


def write_corpus(root: Path, n: int, *, h: int = H, w: int = W, seed: int = 0,
                 solar: bool = True) -> dict:
    """``n`` frames at (h, w) with 0-5 boxes each (some unclear), every
    solar label and an unknown one; the train split lists the frames in a
    shuffled order as integers, the val split a few of them."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        path = root / f"img_{i}.jpg"
        write_jpeg(path, frame(rng, h, w))
        k = int(rng.integers(0, 6))
        x1 = rng.uniform(0, w - 20, k)
        y1 = rng.uniform(0, h - 20, k)
        boxes = np.stack([x1, y1, x1 + rng.uniform(4, 20, k), y1 + rng.uniform(4, 20, k)], -1)
        row = {"frame_id": f"{i:06d}", "resized_image_path": str(path),
               "xyxy_bboxes": [list(map(float, b)) for b in boxes],
               "ped_unclear_list": [bool(u) for u in rng.random(k) < 0.3],
               "ped_present": k > 0}
        if solar:
            row["solar_context_bin"] = SOLAR[i % len(SOLAR)]
        rows.append(row)
    parquet = root / "frames.parquet"
    pd.DataFrame(rows).to_parquet(parquet)
    order = rng.permutation(n)
    train = root / "train_ids.csv"
    train.write_text("frame_id\n" + "\n".join(str(int(i)) for i in order) + "\n")
    val = root / "val_ids.csv"
    val.write_text("frame_id\n" + "\n".join(f"{int(i):06d}" for i in order[:3]) + "\n")
    return {"root": root, "parquet": parquet, "train": train, "val": val}


def require_native():
    """Skip, with the reason, where the port's native decoder cannot be
    built (no g++ or no libjpeg), as the JAX package's tests skip."""
    from multimodal_moe_torch.data import native_decode

    if not native_decode.native_available():
        pytest.skip(f"native decoder not built: {native_decode.build_error}")


def assert_batches_equal(got: dict, want: dict) -> None:
    """The same keys and, key for key, the same dtype, shape and bits."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def to_numpy(batch: dict) -> dict:
    """A batch of torch tensors, JAX arrays or numpy arrays as numpy."""
    out = {}
    for k, v in batch.items():
        out[k] = v.cpu().numpy() if hasattr(v, "cpu") and hasattr(v, "numpy") else np.asarray(v)
    return out
