"""Visual bbox sanity check: draw clear (green) / unclear (red) pedestrian
boxes on sampled frames.

The counterpart of the JAX package's ``scripts/vis_boxes.py``, with its
flags, defaults, picks (``np.random.default_rng(seed).permutation`` over
the same pool) and JPEGs, over the port's ``data/exports.safe_iter_boxes``.
The manual QA gate before export: if boxes look wrong here, do not export
to YOLO/COCO yet. Host code only.

    python -m multimodal_moe_torch.cli.vis_boxes --parquet P --out-dir D
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import paths
from ..data.exports import safe_iter_boxes


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Draw sampled GT boxes for QA.")
    p.add_argument(
        "--parquet", type=str, default=str(paths.ZODMOE_FRAMES_WITH_BOXES_PARQUET)
    )
    p.add_argument(
        "--out-dir",
        type=str,
        default=str(paths.ANALYSIS_DIR / "camera" / "detection" / "bbox_sanity"),
    )
    p.add_argument("--num-frames", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def draw_boxes_on_image(image_path: str, boxes, unclear_flags, out_path: Path) -> None:
    from PIL import Image, ImageDraw

    with Image.open(image_path) as img:
        img = img.convert("RGB")
        draw = ImageDraw.Draw(img)
        for i, box in enumerate(boxes):
            unclear = bool(unclear_flags[i]) if i < len(unclear_flags) else False
            color = (255, 64, 64) if unclear else (64, 255, 64)
            draw.rectangle([tuple(box[:2]), tuple(box[2:])], outline=color, width=2)
        img.save(out_path)


def main(argv=None) -> None:
    import pandas as pd

    args = parse_args(argv)
    df = pd.read_parquet(args.parquet)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # Prefer frames having both clear and unclear pedestrians.
    both = df[(df["ped_count_clear"] > 0) & (df["ped_count_unclear"] > 0)]
    pool = both if len(both) >= args.num_frames else df[df["ped_count_clear"] > 0]
    rng = np.random.default_rng(args.seed)
    picks = pool.iloc[rng.permutation(len(pool))[: args.num_frames]]

    n = 0
    for _, row in picks.iterrows():
        image_path = row["resized_image_path"]
        if image_path is None or not Path(image_path).exists():
            continue
        boxes = [b.tolist() for b in safe_iter_boxes(row["xyxy_bboxes"])]
        unclear = row["ped_unclear_list"] if row["ped_unclear_list"] is not None else []
        out_path = out_dir / f"{str(row['frame_id']).zfill(6)}.jpg"
        draw_boxes_on_image(image_path, boxes, list(unclear), out_path)
        n += 1
    print(f"Wrote {n} annotated frames to {out_dir}")
    print("QA gate: if boxes look wrong here, do NOT export to YOLO/COCO yet.")


if __name__ == "__main__":
    main()
