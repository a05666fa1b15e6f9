"""Batch inference CLI: JPEG/PNG images in → detections out (JSON; optional
annotated copies), on the card.

The counterpart of the JAX package's ``scripts/predict_detector.py``, with
its flags, defaults and outputs, over the evaluator's serving path: uint8
batches → the forward with the loaded tensors applied
(``evaluator.make_inference_step``: decode after top-k for the YOLO
families) → batched NMS (the keep-mask kernel on the card; the top-k
selection for the NMS-free DETR family) → boxes mapped back to each source
image's resolution (a straight bilinear resize, so the inverse is a
per-axis scale). The family (yolo / moe / rtdetr) is read from the run's
``model_config.json``; ``--int8`` takes the PTQ serving path, reusing a
cached ``int8_quant*.npz`` beside the checkpoint and calibrating on the
first input batches otherwise. ``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.predict_detector \\
        --weights outputs/runs/yolo/<run> --images frames/ --draw
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run a trained detector on a directory of images.")
    p.add_argument("--weights", type=str, required=True,
                   help="Run dir (with weights/best), weights dir, or checkpoint dir.")
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--images", type=str, required=True,
                   help="Directory of images (searched non-recursively) or a single image.")
    p.add_argument("--out", type=str, default=None,
                   help="Output dir (default: <images>/predictions).")
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.25,
                   help="Confidence threshold for reported detections.")
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--int8", action="store_true",
                   help="PTQ int8 serving forward (quant.py); cached "
                   "int8_quant.npz beside the checkpoint is reused, else "
                   "scales self-calibrate on the first input batches.")
    p.add_argument("--draw", action="store_true",
                   help="Also write annotated copies next to predictions.json.")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from ..loading import load_detector, quantize_loaded
    from ..ops.nms import batched_nms
    from ..serving import detr_topk_select
    from ..train.evaluator import make_inference_step
    from ._common import cli_device, load_resized

    src = Path(args.images)
    if src.is_dir():
        paths = sorted(
            p for p in src.iterdir() if p.suffix.lower() in _IMG_EXTS
        )
    else:
        paths = [src]
    if not paths:
        raise SystemExit(f"no images under {src}")
    out_dir = Path(args.out) if args.out else src / "predictions"
    out_dir.mkdir(parents=True, exist_ok=True)

    loaded = load_detector(
        args.weights, checkpoint=args.checkpoint,
        img_h=args.img_h, img_w=args.img_w, use_ema=args.use_ema,
        device=cli_device(),
    )

    # ---- load + resize all images (decode on host, straight bilinear) ----
    h, w = args.img_h, args.img_w
    batches, metas = [], []
    cur = []
    for p in paths:
        arr, (w0, h0) = load_resized(p, h, w)
        metas.append({"image": p.name, "width": w0, "height": h0})
        cur.append(arr)
        if len(cur) == args.batch:
            batches.append(np.stack(cur))
            cur = []
    n_valid_last = len(cur) or args.batch
    if cur:  # pad the tail batch to the fixed shape
        pad = args.batch - len(cur)
        batches.append(np.stack(cur + [np.zeros((h, w, 3), np.uint8)] * pad))

    if args.int8:
        # calibration contract: normalized float batches (quant.calibrate)
        calib = [b.astype(np.float32) / 255.0 for b in batches[:2]]
        loaded = quantize_loaded(loaded, calib)
    family, model, variables = loaded.family, loaded.model, loaded.variables

    infer = make_inference_step(model)
    results = []
    idx = 0
    for bi, batch in enumerate(batches):
        boxes, scores = infer(variables, batch)
        with torch.inference_mode():
            if family == "rtdetr":
                nms = detr_topk_select(boxes, scores, max_det=args.max_det,
                                       score_threshold=args.conf)
            else:
                nms = batched_nms(
                    boxes, scores,
                    iou_threshold=args.iou, score_threshold=args.conf,
                    max_det=args.max_det,
                )
        nb = nms.boxes.cpu().numpy()
        ns = nms.scores.cpu().numpy()
        nv = nms.valid.cpu().numpy()
        rows = batch.shape[0] if bi < len(batches) - 1 else n_valid_last
        for i in range(rows):
            meta = metas[idx]
            sx, sy = meta["width"] / w, meta["height"] / h
            keep = nv[i] & (ns[i] >= args.conf)
            xyxy = nb[i][keep] * np.array([sx, sy, sx, sy])
            xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, meta["width"])
            xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, meta["height"])
            results.append({
                **meta,
                "detections": [
                    {"xyxy": [round(float(v), 2) for v in b],
                     "score": round(float(s), 4)}
                    for b, s in zip(xyxy, ns[i][keep])
                ],
            })
            idx += 1

    (out_dir / "predictions.json").write_text(json.dumps(results, indent=1))
    n_det = sum(len(r["detections"]) for r in results)
    print(f"{len(results)} images -> {n_det} detections @conf>={args.conf} "
          f"-> {out_dir / 'predictions.json'}")

    if args.draw:
        from PIL import Image, ImageDraw

        by_name = {p.name: p for p in paths}
        for r in results:
            p = by_name[r["image"]]
            with Image.open(p) as im:
                im = im.convert("RGB")
                d = ImageDraw.Draw(im)
                for det in r["detections"]:
                    x1, y1, x2, y2 = det["xyxy"]
                    d.rectangle([x1, y1, x2, y2], outline=(255, 40, 40), width=3)
                    d.text((x1 + 2, max(0.0, y1 - 12)), f"{det['score']:.2f}",
                           fill=(255, 40, 40))
                im.save(out_dir / f"pred_{r['image']}")
        print(f"annotated copies -> {out_dir}/pred_*.jpg")


if __name__ == "__main__":
    main()
