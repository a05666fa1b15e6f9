"""Dataset over an exported Ultralytics/YOLO layout (dataset.yaml +
images/<split>/ + labels/<split>/*.txt).

The port's own copy of ``multimodal_moe_tpu/data/yolo_layout.py``: an
exported layout trains directly, no parquet needed. Label lines are
``cls xc yc w h`` normalized center-format; boxes come back in absolute-pixel
xyxy, padded to ``max_boxes``. Samples are those of JAX's dataset, bitwise
(``tests/test_torch_yolo_layout.py``); PIL is imported inside ``load``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class YoloLayoutConfig:
    dataset_yaml: str
    split: str = "train"
    img_h: int = 704
    img_w: int = 1248
    max_boxes: int = 96


def _parse_dataset_yaml(path: Path) -> Dict[str, str]:
    """Minimal parser for the flat Ultralytics dataset.yaml the exporter
    writes (path/train/val/test/nc/names)."""
    out: Dict[str, str] = {}
    for line in path.read_text().splitlines():
        if ":" in line and not line.startswith(" "):
            key, _, value = line.partition(":")
            out[key.strip()] = value.strip()
    return out


class YoloLayoutDataset:
    """Same sample contract as :class:`ZODMoEVisionDataset` (``load(i)`` →
    fixed-shape dict) so :class:`DetectionLoader` works unchanged."""

    def __init__(self, cfg: YoloLayoutConfig):
        self.cfg = cfg
        yaml_path = Path(cfg.dataset_yaml)
        if not yaml_path.exists():
            raise FileNotFoundError(f"dataset.yaml not found: {yaml_path}")
        meta = _parse_dataset_yaml(yaml_path)
        root = Path(meta.get("path", str(yaml_path.parent)))
        split_rel = meta.get(cfg.split, f"images/{cfg.split}")
        self.images_dir = root / split_rel
        if not self.images_dir.exists():
            raise FileNotFoundError(f"split images dir not found: {self.images_dir}")
        # labels dir mirrors images dir (Ultralytics convention)
        self.labels_dir = Path(str(self.images_dir).replace("images", "labels", 1))
        self.image_paths: List[Path] = sorted(
            p for p in self.images_dir.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png")
        )
        if not self.image_paths:
            raise RuntimeError(f"no images under {self.images_dir}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def _read_labels(self, image_path: Path) -> np.ndarray:
        label_path = self.labels_dir / (image_path.stem + ".txt")
        if not label_path.exists():
            return np.zeros((0, 5), np.float32)
        rows = []
        for line in label_path.read_text().splitlines():
            parts = line.split()
            if len(parts) == 5:
                rows.append([float(v) for v in parts])
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)

    def load(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        cfg = self.cfg
        path = self.image_paths[i]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if img.size != (cfg.img_w, cfg.img_h):
                img = img.resize((cfg.img_w, cfg.img_h), Image.BILINEAR)
            image = np.asarray(img, dtype=np.uint8)

        labels = self._read_labels(path)
        boxes = np.zeros((cfg.max_boxes, 4), np.float32)
        cls = np.zeros(cfg.max_boxes, np.int32)
        mask = np.zeros(cfg.max_boxes, bool)
        n = min(len(labels), cfg.max_boxes)
        if n:
            xc = labels[:n, 1] * cfg.img_w
            yc = labels[:n, 2] * cfg.img_h
            w = labels[:n, 3] * cfg.img_w
            h = labels[:n, 4] * cfg.img_h
            boxes[:n] = np.stack(
                [xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], axis=-1
            )
            cls[:n] = labels[:n, 0].astype(np.int32)
            mask[:n] = True

        return {
            "image": image,
            "gt_boxes": boxes,
            "gt_labels": cls,
            "gt_mask": mask,
            "label": np.int32(int(mask.any())),
            "solar_bin": np.int32(5),  # layout carries no context → "missing"
        }

    def __getitem__(self, i: int):
        s = self.load(i)
        return s["image"], s["label"]
