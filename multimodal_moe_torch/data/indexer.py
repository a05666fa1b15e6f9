"""ZOD frame indexing: raw frame dirs → one canonical parquet row per frame.

The port's own copy of ``multimodal_moe_tpu/data/indexer.py``:

* discover frames via ``**/metadata.json`` (sorted)
* locate exactly one non-resized ``camera_front_dnat/*.jpg`` (raise on
  ambiguity)
* bilinear resize 3848×2168 → 1248×704, JPEG quality 95
* parse pedestrian annotations: unclear flag, occlusion buckets, multipoint
  normalization and rescale
* derived labels ``ped_bin_4`` ∈ {0, 1–5, 6–15, >15} and ``ped_present``
* parallel arrays: per frame, ``ped_points_xy_resized[i]``, ``ped_uuid[i]``,
  ``ped_unclear_list[i]``, ``ped_occlusion_list[i]`` describe the same
  pedestrian

Decode and resize run on a thread pool; ``ThreadPoolExecutor.map`` keeps
the sorted ``metadata.json`` order, so the rows are JAX's, row for row
(``tests/test_torch_ingest_chain.py``). pandas and PIL are imported where
they are used; tqdm is optional.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ORIG_W, ORIG_H = 3848, 2168
NEW_W, NEW_H = 1248, 704


@dataclass(frozen=True)
class IndexConfig:
    zod_root: Path
    out_parquet: Path
    resized_img_root: Optional[Path] = None  # None → skip writing resized images
    orig_w: int = ORIG_W
    orig_h: int = ORIG_H
    new_w: int = NEW_W
    new_h: int = NEW_H
    jpeg_quality: int = 95
    workers: int = 16
    max_frames: Optional[int] = None  # smoke-test cap

    @property
    def sx(self) -> float:
        return self.new_w / self.orig_w

    @property
    def sy(self) -> float:
        return self.new_h / self.orig_h


def read_json(path: Path) -> Any:
    try:
        with path.open("r") as f:
            return json.load(f)
    except Exception:
        return None


def ped_bin_4(ped_count_clear: int) -> int:
    """Pedestrian-count bin: 0 / 1–5 / 6–15 / >15."""
    if ped_count_clear == 0:
        return 0
    if ped_count_clear <= 5:
        return 1
    if ped_count_clear <= 15:
        return 2
    return 3


def find_front_dnat_image(frame_dir: Path) -> Optional[Path]:
    """Locate the single non-resized front-DNAT jpg; raise on ambiguity."""
    cam_dir = frame_dir / "camera_front_dnat"
    if not cam_dir.exists():
        return None
    candidates = sorted(cam_dir.glob("*.jpg"))
    if not candidates:
        return None
    non_resized = [p for p in candidates if "resized" not in p.name.lower()]
    if len(non_resized) == 1:
        return non_resized[0]
    if len(non_resized) == 0:
        return None
    raise ValueError(
        f"Expected exactly one non-resized DNAT jpg in {cam_dir}, found "
        f"{len(non_resized)}: {[p.name for p in non_resized]}"
    )


def normalize_multipoint_coords(coords: Any) -> List[List[float]]:
    """Flatten ZOD MultiPoint shapes ``[[x,y],...]`` or ``[[[x,y],...]]`` to
    a list of ``[x, y]``."""
    if not isinstance(coords, list) or len(coords) == 0:
        return []
    if (
        len(coords) == 1
        and isinstance(coords[0], list)
        and len(coords[0]) > 0
        and isinstance(coords[0][0], (list, tuple))
    ):
        coords = coords[0]
    pts: List[List[float]] = []
    for pt in coords:
        if not (isinstance(pt, (list, tuple)) and len(pt) >= 2):
            continue
        x, y = pt[0], pt[1]
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            pts.append([float(x), float(y)])
    return pts


def resize_points_xy(points_xy: List[List[float]], sx: float, sy: float) -> List[List[float]]:
    """Scale raw-pixel points into the resized image's frame (float32)."""
    if not points_xy:
        return []
    arr = np.asarray(points_xy, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] < 2:
        return []
    scaled = arr[:, :2] * np.asarray([sx, sy], dtype=np.float32)
    return scaled.tolist()


def occlusion_bucket(occ: Any) -> str:
    """Normalize ZOD occlusion ratios to the fixed bucket vocabulary."""
    if occ is None:
        return "missing"
    s = str(occ).strip().lower()
    if s in ("none", "light", "medium", "heavy", "veryheavy"):
        return s
    return "unknown"


_OCC_COUNT_KEYS = {
    "none": "ped_occ_none",
    "light": "ped_occ_light",
    "medium": "ped_occ_medium",
    "heavy": "ped_occ_heavy",
    "veryheavy": "ped_occ_veryheavy",
    "missing": "ped_occ_missing",
    "unknown": "ped_occ_unknown",
}


def parse_pedestrian_annotations(annotations: Any, sx: float, sy: float) -> Dict[str, Any]:
    """One frame's pedestrian annotations → the parallel arrays and the
    per-bucket counts. A dict holds its list under ``"annotations"``."""
    if annotations is None:
        annotations = []
    if isinstance(annotations, dict):
        annotations = annotations.get("annotations", [])

    out: Dict[str, Any] = {k: 0 for k in _OCC_COUNT_KEYS.values()}
    out.update(
        ped_count_clear=0,
        ped_count_unclear=0,
        ped_uuid=[],
        ped_unclear_list=[],
        ped_occlusion_list=[],
        ped_points_xy_resized=[],
    )

    for obj in annotations:
        if not isinstance(obj, dict):
            continue
        props = obj.get("properties", {}) or {}
        if props.get("class") != "Pedestrian":
            continue

        unclear = bool(props.get("unclear", False))
        if unclear:
            out["ped_count_unclear"] += 1
        else:
            out["ped_count_clear"] += 1

        bucket = occlusion_bucket(props.get("occlusion_ratio", None))
        out[_OCC_COUNT_KEYS[bucket]] += 1

        geom = obj.get("geometry", {}) or {}
        coords = normalize_multipoint_coords(geom.get("coordinates", None))
        if len(coords) != 4:
            continue
        coords_resized = resize_points_xy(coords, sx, sy)
        if len(coords_resized) != 4:
            continue

        out["ped_points_xy_resized"].append(coords_resized)
        out["ped_uuid"].append(str(props.get("annotation_uuid", "")))
        out["ped_unclear_list"].append(unclear)
        out["ped_occlusion_list"].append(bucket)

    return out


def _resize_and_save(cfg: IndexConfig, image_path: Path, dst: Path) -> bool:
    """Bilinear resize to the configured size and save as JPEG; ``False`` on
    any failure."""
    from PIL import Image

    try:
        img = Image.open(image_path).convert("RGB")
        img = img.resize((cfg.new_w, cfg.new_h), resample=Image.BILINEAR)
        img.save(dst, quality=cfg.jpeg_quality)
        return True
    except Exception:
        return False


def index_one_frame(cfg: IndexConfig, meta_path: Path) -> Optional[Dict[str, Any]]:
    """Build one parquet row from a frame dir, or ``None`` to skip the frame."""
    frame_dir = meta_path.parent
    metadata = read_json(meta_path)
    if metadata is None or not isinstance(metadata, dict):
        return None

    frame_id = metadata.get("frame_id", frame_dir.name)

    image_path = find_front_dnat_image(frame_dir)
    if image_path is None:
        return None

    resized_image_path: Optional[Path] = None
    if cfg.resized_img_root is not None:
        resized_image_path = cfg.resized_img_root / f"{frame_id}.jpg"
        if not resized_image_path.exists():
            if not _resize_and_save(cfg, image_path, resized_image_path):
                return None

    anns = read_json(frame_dir / "annotations" / "object_detection.json")
    ped = parse_pedestrian_annotations(anns, cfg.sx, cfg.sy)

    ped_bin = ped_bin_4(ped["ped_count_clear"])
    row: Dict[str, Any] = dict(
        frame_id=frame_id,
        time=metadata.get("time"),
        image_path=str(image_path),
        resized_image_path=str(resized_image_path) if resized_image_path is not None else None,
        orig_w=cfg.orig_w,
        orig_h=cfg.orig_h,
        new_w=cfg.new_w,
        new_h=cfg.new_h,
        sx=float(cfg.sx),
        sy=float(cfg.sy),
        scraped_weather=metadata.get("scraped_weather"),
        time_of_day=metadata.get("time_of_day"),
        solar_angle_elevation=metadata.get("solar_angle_elevation"),
        country_code=metadata.get("country_code"),
        road_type=metadata.get("road_type"),
        road_condition=metadata.get("road_condition"),
        ped_count_clear=int(ped["ped_count_clear"]),
        ped_count_unclear=int(ped["ped_count_unclear"]),
        ped_occ_none=int(ped["ped_occ_none"]),
        ped_occ_light=int(ped["ped_occ_light"]),
        ped_occ_medium=int(ped["ped_occ_medium"]),
        ped_occ_heavy=int(ped["ped_occ_heavy"]),
        ped_occ_veryheavy=int(ped["ped_occ_veryheavy"]),
        ped_occ_missing=int(ped["ped_occ_missing"]),
        ped_occ_unknown=int(ped["ped_occ_unknown"]),
        ped_uuid=ped["ped_uuid"],
        ped_unclear_list=ped["ped_unclear_list"],
        ped_occlusion_list=ped["ped_occlusion_list"],
        ped_points_xy_resized=ped["ped_points_xy_resized"],
        ped_bin_4=int(ped_bin),
        ped_present=int(ped_bin > 0),
    )
    return row


def build_index(cfg: IndexConfig, progress: bool = True):
    """Walk the ZOD root and build the canonical frame index
    (``pandas.DataFrame``), rows in sorted ``metadata.json`` order."""
    import pandas as pd

    if cfg.resized_img_root is not None:
        cfg.resized_img_root.mkdir(parents=True, exist_ok=True)

    metadata_files = sorted(cfg.zod_root.rglob("metadata.json"))
    if cfg.max_frames is not None:
        metadata_files = metadata_files[: cfg.max_frames]

    iterator = metadata_files
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(metadata_files, desc="Indexing frames")
        except ImportError:
            pass

    rows: List[Dict[str, Any]] = []
    with ThreadPoolExecutor(max_workers=cfg.workers) as pool:
        for row in pool.map(lambda p: index_one_frame(cfg, p), iterator):
            if row is not None:
                rows.append(row)
    return pd.DataFrame(rows)


def write_index(cfg: IndexConfig, progress: bool = True) -> Path:
    """Build and persist the canonical parquet index."""
    cfg.out_parquet.parent.mkdir(parents=True, exist_ok=True)
    df = build_index(cfg, progress=progress)
    df.to_parquet(cfg.out_parquet, index=False, engine="pyarrow")
    return cfg.out_parquet


def add_xyxy_bboxes(df):
    """The box stage: each pedestrian's multipoint → xyxy, clamped to pixel
    indices, kept where at least 2 px a side; an ``xyxy_bboxes`` column on a
    copy of ``df``."""
    from .bboxes import clamp_xyxy, is_valid_box, points_to_xyxy

    out_col = []
    for _, row in df.iterrows():
        img_w, img_h = int(row["new_w"]), int(row["new_h"])
        frame_boxes = []
        for ped_points in row["ped_points_xy_resized"]:
            box = points_to_xyxy(ped_points)
            if box is None:
                continue
            box = clamp_xyxy(box, img_w, img_h)
            if is_valid_box(box):
                frame_boxes.append(box)
        out_col.append(frame_boxes)
    out = df.copy()
    out["xyxy_bboxes"] = out_col
    return out
