"""Detector-ready dataset exporters: the Ultralytics/YOLO layout and COCO JSON.

The port's own copy of ``multimodal_moe_tpu/data/exports.py``:

* YOLO layout: a label ``.txt`` per frame with ``cls xc yc w h`` at 6
  decimals, symlinked images, the unclear-box policy, range guardrails,
  export summary counts, and the ``dataset.yaml`` writer.
* COCO JSON: ``instances_{split}.json`` with images / annotations /
  categories (category_id 1 = "pedestrian"), boxes clamped to ``[0, W]``,
  the per-image ``solar_context_bin``, and an export summary.
* ``safe_iter_boxes``: the box-container normalization the loaders also
  use to read a row's boxes.

The exporters take split-filtered frames from
:func:`multimodal_moe_torch.data.index.load_split_frames` and write the same
files as JAX's (``tests/test_torch_ingest_modules.py``). pandas is imported
by the caller; nothing here imports it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Literal, Optional

import numpy as np

from .bboxes import xyxy_to_yolo

UnclearPolicy = Literal["keep_all", "exclude_unclear"]


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _ensure_dir(path: Path) -> None:
    path.mkdir(parents=True, exist_ok=True)


def _symlink_image(src: Path, dst: Path) -> None:
    """Symlink (not copy) an image into the export tree. The target is
    resolved to an absolute path first: a relative ``src`` would otherwise
    be read relative to ``dst``'s directory and dangle."""
    if dst.exists() or dst.is_symlink():
        return
    dst.symlink_to(src.resolve())


def safe_iter_boxes(xyxy_bboxes) -> "List[np.ndarray]":
    """Normalize box containers (ndarray / list / object arrays) into a list
    of ``(4,)`` float arrays; anything else gives no boxes."""
    if xyxy_bboxes is None:
        return []
    arr = np.asarray(xyxy_bboxes)
    if arr.size == 0:
        return []
    if arr.dtype == object:
        out: List[np.ndarray] = []
        for item in xyxy_bboxes:
            item_arr = np.asarray(item, dtype=np.float32)
            if item_arr.shape == (4,):
                out.append(item_arr)
        return out
    if arr.ndim == 2 and arr.shape[1] == 4:
        return [arr[i] for i in range(arr.shape[0])]
    if arr.ndim == 1 and arr.shape[0] == 4:
        return [arr]
    return []


def _unclear_flags(row_value) -> np.ndarray:
    return np.asarray(row_value) if row_value is not None else np.asarray([])


def _require_columns(frames_df, needed: "list[str]") -> None:
    for col in needed:
        if col not in frames_df.columns:
            raise ValueError(f"frames_df missing required column '{col}'")


# ---------------------------------------------------------------------------
# YOLO export
# ---------------------------------------------------------------------------

@dataclass
class YoloExportSummary:
    """Per-split export accounting."""

    split: str
    n_frames: int
    n_images_written: int
    n_label_files_written: int
    n_boxes_written: int
    n_boxes_dropped_unclear: int
    n_empty_label_files: int


def export_yolo_split(
    split_name: str,
    frames_df,
    out_dataset_dir: "str | Path",
    image_path_col: str = "resized_image_path",
    frame_id_col: str = "frame_id",
    boxes_col: str = "xyxy_bboxes",
    unclear_col: str = "ped_unclear_list",
    img_w_col: str = "new_w",
    img_h_col: str = "new_h",
    unclear_policy: UnclearPolicy = "exclude_unclear",
    class_id: int = 0,
) -> YoloExportSummary:
    """Export one split (a ``pandas.DataFrame``) to the Ultralytics
    images/labels layout."""
    out_dataset_dir = Path(out_dataset_dir)
    images_dir = out_dataset_dir / "images" / split_name
    labels_dir = out_dataset_dir / "labels" / split_name
    _ensure_dir(images_dir)
    _ensure_dir(labels_dir)
    _require_columns(
        frames_df, [frame_id_col, image_path_col, boxes_col, unclear_col, img_w_col, img_h_col]
    )

    n_images_written = 0
    n_label_files_written = 0
    n_boxes_written = 0
    n_boxes_dropped_unclear = 0
    n_empty_label_files = 0

    for _, row in frames_df.iterrows():
        frame_id = str(row[frame_id_col]).zfill(6)
        src_image_path = Path(row[image_path_col])
        if not src_image_path.exists():
            continue  # a missing image skips the frame

        _symlink_image(src=src_image_path, dst=images_dir / f"{frame_id}.jpg")
        n_images_written += 1

        boxes = safe_iter_boxes(row[boxes_col])
        unclear = _unclear_flags(row[unclear_col])
        img_w = float(row[img_w_col])
        img_h = float(row[img_h_col])

        label_lines: List[str] = []
        for i, box in enumerate(boxes):
            is_unclear = bool(unclear[i]) if i < len(unclear) else False
            if unclear_policy == "exclude_unclear" and is_unclear:
                n_boxes_dropped_unclear += 1
                continue

            xc, yc, w, h = xyxy_to_yolo(box.tolist(), img_w=int(img_w), img_h=int(img_h))
            # Degenerate or out-of-range boxes never reach disk.
            if w <= 0.0 or h <= 0.0:
                continue
            if not (0.0 <= xc <= 1.0 and 0.0 <= yc <= 1.0 and 0.0 < w <= 1.0 and 0.0 < h <= 1.0):
                continue
            label_lines.append(f"{class_id} {xc:.6f} {yc:.6f} {w:.6f} {h:.6f}")
            n_boxes_written += 1

        (labels_dir / f"{frame_id}.txt").write_text(
            "\n".join(label_lines) + ("\n" if label_lines else "")
        )
        n_label_files_written += 1
        if not label_lines:
            n_empty_label_files += 1

    return YoloExportSummary(
        split=split_name,
        n_frames=len(frames_df),
        n_images_written=n_images_written,
        n_label_files_written=n_label_files_written,
        n_boxes_written=n_boxes_written,
        n_boxes_dropped_unclear=n_boxes_dropped_unclear,
        n_empty_label_files=n_empty_label_files,
    )


def write_yolo_dataset_yaml(
    out_dataset_dir: "str | Path",
    class_names: "dict[int, str] | list[str]",
    yaml_path: "str | Path | None" = None,
) -> Path:
    """Write the Ultralytics ``dataset.yaml`` descriptor."""
    out_dataset_dir = Path(out_dataset_dir)
    _ensure_dir(out_dataset_dir)
    yaml_path = Path(yaml_path) if yaml_path is not None else out_dataset_dir / "dataset.yaml"

    if isinstance(class_names, dict):
        names = [name for _, name in sorted(class_names.items(), key=lambda kv: kv[0])]
    else:
        names = list(class_names)

    lines = [
        f"path: {str(out_dataset_dir.resolve())}",
        "train: images/train",
        "val: images/val",
        "test: images/test",
        f"nc: {len(names)}",
        "names:",
    ]
    lines += [f"  {i}: {name}" for i, name in enumerate(names)]
    yaml_path.write_text("\n".join(lines) + "\n")
    return yaml_path


# ---------------------------------------------------------------------------
# COCO export
# ---------------------------------------------------------------------------

@dataclass
class CocoExportSummary:
    """Per-split export accounting."""

    split: str
    n_frames: int
    n_images_written: int
    n_annotations_written: int
    n_boxes_dropped_unclear: int
    n_images_without_boxes: int
    ann_json_path: str


def xyxy_to_coco_xywh(
    box: np.ndarray, img_w: float, img_h: float
) -> "Optional[tuple[float, float, float, float]]":
    """Clamp to ``[0, W] × [0, H]`` then convert to top-left xywh; ``None``
    if degenerate after clamping. The clamp is to the image extent (COCO's
    coordinates), not :func:`clamp_xyxy`'s ``W-1`` pixel index."""
    x1, y1, x2, y2 = (float(v) for v in np.asarray(box).tolist())
    x1 = min(max(x1, 0.0), img_w)
    y1 = min(max(y1, 0.0), img_h)
    x2 = min(max(x2, 0.0), img_w)
    y2 = min(max(y2, 0.0), img_h)
    w = x2 - x1
    h = y2 - y1
    if w <= 0.0 or h <= 0.0:
        return None
    return x1, y1, w, h


def export_coco_split(
    *,
    split_name: str,
    frames_df,
    out_dataset_dir: "str | Path",
    image_path_col: str = "resized_image_path",
    frame_id_col: str = "frame_id",
    boxes_col: str = "xyxy_bboxes",
    unclear_col: str = "ped_unclear_list",
    img_w_col: str = "new_w",
    img_h_col: str = "new_h",
    solar_bin_col: str = "solar_context_bin",
    unclear_policy: UnclearPolicy = "exclude_unclear",
    category_id: int = 1,
) -> CocoExportSummary:
    """Export one split (a ``pandas.DataFrame``) to COCO
    ``annotations/instances_{split}.json`` and symlinked images."""
    out_dataset_dir = Path(out_dataset_dir)
    images_dir = out_dataset_dir / "images" / split_name
    ann_dir = out_dataset_dir / "annotations"
    _ensure_dir(images_dir)
    _ensure_dir(ann_dir)
    _require_columns(
        frames_df, [frame_id_col, image_path_col, boxes_col, unclear_col, img_w_col, img_h_col]
    )

    images = []
    annotations = []
    ann_id = 1
    n_images_written = 0
    n_annotations_written = 0
    n_boxes_dropped_unclear = 0
    n_images_without_boxes = 0

    for image_id, (_, row) in enumerate(frames_df.iterrows(), start=1):
        frame_id = str(row[frame_id_col]).zfill(6)
        src_img = Path(row[image_path_col])
        if not src_img.exists():
            continue

        _symlink_image(src=src_img, dst=images_dir / f"{frame_id}.jpg")
        n_images_written += 1

        img_w = float(row[img_w_col])
        img_h = float(row[img_h_col])
        image_entry = {
            "id": int(image_id),
            "file_name": f"{frame_id}.jpg",
            "width": int(round(img_w)),
            "height": int(round(img_h)),
        }
        # The routing context rides along per image, COCO-compatibly.
        if solar_bin_col in frames_df.columns:
            solar_value = row[solar_bin_col]
            image_entry["solar_context_bin"] = None if solar_value is None else str(solar_value)
        images.append(image_entry)

        boxes = safe_iter_boxes(row[boxes_col])
        unclear = _unclear_flags(row[unclear_col])
        image_box_count = 0

        for i, box in enumerate(boxes):
            is_unclear = bool(unclear[i]) if i < len(unclear) else False
            if unclear_policy == "exclude_unclear" and is_unclear:
                n_boxes_dropped_unclear += 1
                continue
            coco_box = xyxy_to_coco_xywh(box, img_w=img_w, img_h=img_h)
            if coco_box is None:
                continue
            x, y, w, h = coco_box
            annotations.append(
                {
                    "id": int(ann_id),
                    "image_id": int(image_id),
                    "category_id": int(category_id),
                    "bbox": [x, y, w, h],
                    "area": float(w * h),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
            n_annotations_written += 1
            image_box_count += 1

        if image_box_count == 0:
            n_images_without_boxes += 1

    coco = {
        "info": {
            "description": "ZOD pedestrian detection export",
            "version": "1.0",
            "year": 2026,
        },
        "licenses": [],
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": int(category_id), "name": "pedestrian", "supercategory": "person"}
        ],
    }
    ann_json_path = ann_dir / f"instances_{split_name}.json"
    ann_json_path.write_text(json.dumps(coco, indent=2))

    return CocoExportSummary(
        split=split_name,
        n_frames=int(len(frames_df)),
        n_images_written=int(n_images_written),
        n_annotations_written=int(n_annotations_written),
        n_boxes_dropped_unclear=int(n_boxes_dropped_unclear),
        n_images_without_boxes=int(n_images_without_boxes),
        ann_json_path=str(ann_json_path),
    )
