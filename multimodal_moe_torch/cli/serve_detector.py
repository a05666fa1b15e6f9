"""Detection serving CLI: a trained run dir behind an HTTP endpoint with
dynamic batching (``multimodal_moe_torch/server.py``), on the card.

The counterpart of the JAX package's ``scripts/serve_detector.py``, with
its flags and defaults: one resident model at a fixed batch, requests
coalesced up to ``--batch`` or ``--max-wait-ms``, detections returned in
source-image pixel space. ``MMOE_PLATFORM=cpu`` serves on the CPU.

    python -m multimodal_moe_torch.cli.serve_detector \\
        --weights outputs/runs/yolo/<run> --port 8000 --batch 16
    curl -X POST --data-binary @frame.jpg \\
        'http://127.0.0.1:8000/predict?conf=0.25'
    curl http://127.0.0.1:8000/healthz

A run dir written by the JAX package (Orbax checkpoints) is first
converted with ``python tools/orbax_to_torch.py``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve a trained detector over HTTP.")
    p.add_argument("--weights", type=str, required=True,
                   help="Run dir (with weights/best), weights dir, or checkpoint dir.")
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=20.0,
                   help="Batching window: a request waits at most this long "
                   "for the batch to fill before the step launches.")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--pool", type=int, default=512,
                   help="NMS candidate pool (decode-after-top-k size).")
    p.add_argument("--early-exit", action="store_true",
                   help="Exact early-exit NMS variant (serving.py).")
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--int8", action="store_true",
                   help="PTQ int8 serving (quant.py). Uses the cached "
                   "int8_quant.npz beside the checkpoint, else calibrates "
                   "on --calib-images.")
    p.add_argument("--calib-images", type=str, default=None,
                   help="Directory of images for int8 calibration when no "
                   "cached npz exists.")
    p.add_argument("--int8-fp-box", action="store_true",
                   help="int8 with the DFL box branch kept fp (yolo/moe) - "
                   "the strict-IoU PTQ accuracy mode.")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from ..loading import load_detector, quantize_loaded
    from ..server import BatchingDetector, serve_forever
    from ._common import cli_device, load_resized

    loaded = load_detector(
        args.weights, checkpoint=args.checkpoint,
        img_h=args.img_h, img_w=args.img_w, use_ema=args.use_ema,
        device=cli_device(),
    )
    if args.int8:
        calib = []
        have_npz = any(
            (loaded.ckpt_path.parent / n).exists()
            for n in ("int8_quant.npz",
                      f"int8_quant_{loaded.ckpt_path.name}.npz")
        )
        if not have_npz:
            if not args.calib_images:
                raise SystemExit(
                    "--int8 without a cached int8_quant.npz needs "
                    "--calib-images"
                )
            import numpy as np

            paths = sorted(Path(args.calib_images).iterdir())[:8]
            arrs = [load_resized(p, args.img_h, args.img_w)[0].astype(np.float32) / 255.0
                    for p in paths]
            if not arrs:
                raise SystemExit(f"no calibration images under {args.calib_images}")
            calib = [np.stack(arrs)]
        loaded = quantize_loaded(loaded, calib, fp_box=args.int8_fp_box)

    detector = BatchingDetector(
        loaded.model, loaded.variables,
        batch=args.batch, img_h=args.img_h, img_w=args.img_w,
        conf=args.conf, iou_threshold=args.iou, max_det=args.max_det,
        pool=args.pool, early_exit=args.early_exit,
        max_wait_ms=args.max_wait_ms,
    )
    print(f"[serve] {loaded.family} from {loaded.ckpt_path} on {detector.device}; "
          "warming up…", flush=True)
    detector.warmup()
    serve_forever(detector, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
