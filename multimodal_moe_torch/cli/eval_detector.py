"""Evaluate a trained detector run on a split and write the uniform artifact
schema, on the card.

The counterpart of the JAX package's ``scripts/eval_detector.py``, with its
flags, defaults and outputs: ``metrics.json`` (with the derived fps keys,
``params_total``, ``flops_g`` of the fp model and, with ``--int8``,
``quantization``), ``metrics_table.csv`` and ``run_metadata.{json,csv}``
under ``paths.EVAL_DIR/<backend>/<run-name>/``. ``--weights`` is a run dir
(``model_config.json`` beside ``weights/{best,last}``), a weights dir or a
checkpoint dir, restored without its optimizer state
(``loading.load_detector``), so a run converted by
``tools/orbax_to_torch.py`` evaluates too. ``--int8`` takes the PTQ serving
path (``loading.quantize_loaded``): the quant tree cached as
``int8_quant_<ckpt>.npz`` beside the checkpoint is reused, else calibrated
on the first train batches and written there. YOLO and MoE-YOLO batches go
through the NMS keep-mask kernel (B1), RT-DETR's through the deformable
attention kernel (B4) and the NMS-free top-k. ``MMOE_PLATFORM=cpu`` runs on
the CPU.

    python -m multimodal_moe_torch.cli.eval_detector --backend moe \\
        --weights outputs/runs/moe/<run> --run-name moe_eval
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate detector run.")
    p.add_argument("--backend", choices=["yolo", "rtdetr", "moe"], default="yolo")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--splits-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--weights", type=str, required=True,
                   help="Run dir (with weights/best) or checkpoint dir.")
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--split", choices=["train", "val", "test"], default="val")
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--run-name", type=str, default="yolo_eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--unclear-policy", type=str, default="exclude_unclear")
    p.add_argument("--nms-iou", type=float, default=0.7)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--int8", action="store_true",
                   help="PTQ int8 serving path: calibrate on train batches, fold BN, quantize, "
                   "eval the int8 forward (yolo/moe: full conv trunk; rtdetr: backbone + CCFF "
                   "encoder convs, fp AIFI/decoder). The quant tree is cached as "
                   "int8_quant_<ckpt>.npz beside the checkpoint.")
    p.add_argument("--int8-calib-batches", type=int, default=8)
    p.add_argument("--int8-recalibrate", action="store_true")
    p.add_argument("--int8-fp-box", action="store_true",
                   help="int8 serving with the DFL box-regression branch kept fp (yolo/moe). "
                   "The quant npz is still built for the full-int8 model (a superset), so "
                   "both modes share one calibration.")
    p.add_argument("--int8-calib-mode", choices=("absmax", "avgmax"), default="absmax",
                   help="Activation-scale statistic: absmax = running max over all calib "
                   "batches; avgmax = mean of per-batch absmax (see quant.calibrate).")
    return p.parse_args(argv)


def calib_batches(args, n: int):
    """The first ``n`` full train-split batches as normalized float NHWC
    arrays (``quant.calibrate``'s input), read only as they are taken."""
    import numpy as np

    from ..data.pipeline import DetectionLoader, ZODMoEDataConfig, ZODMoEVisionDataset

    ds = ZODMoEVisionDataset(ZODMoEDataConfig(
        frames_parquet=args.parquet, split_csv=str(Path(args.splits_dir) / "train_ids.csv"),
        img_h=args.img_h, img_w=args.img_w,
        unclear_policy=getattr(args, "unclear_policy", "exclude_unclear")))
    for i, batch in enumerate(DetectionLoader(ds, batch_size=args.batch, drop_last=True)):
        if i >= n:
            break
        yield np.asarray(batch["image"]).astype(np.float32) / 255.0


def main(argv=None) -> None:
    args = parse_args(argv)

    from ..data.pipeline import DetectionLoader, ZODMoEDataConfig, ZODMoEVisionDataset
    from ..loading import load_detector, quantize_loaded
    from ..models.yolo import count_params
    from ..train.artifacts import (
        add_derived_speed_metrics,
        collect_runtime_info,
        infer_model_variant_from_weights,
        save_metrics_json,
        save_metrics_table_csv,
        save_run_metadata_artifacts,
    )
    from ..train.evaluator import evaluate_detector, make_inference_fn, model_flops_g
    from ._common import cli_device

    device = cli_device()
    loaded = load_detector(args.weights, checkpoint=args.checkpoint, img_h=args.img_h,
                           img_w=args.img_w, use_ema=args.use_ema, device=device,
                           default_family=args.backend)
    family, ckpt_path = loaded.family, loaded.ckpt_path
    variant = loaded.model_cfg.get("variant", "s")
    fp_model = loaded.model

    ds = ZODMoEVisionDataset(ZODMoEDataConfig(
        frames_parquet=args.parquet,
        split_csv=str(Path(args.splits_dir) / f"{args.split}_ids.csv"),
        img_h=args.img_h, img_w=args.img_w, unclear_policy=args.unclear_policy))
    loader = DetectionLoader(ds, batch_size=args.batch, drop_last=False)

    quantization = "none"
    if args.int8:
        qnpz = ckpt_path.parent / f"int8_quant_{ckpt_path.name}.npz"
        cached = qnpz.exists() and not args.int8_recalibrate
        taken = []
        batches = (taken.append(b) or b for b in calib_batches(args, args.int8_calib_batches))
        loaded = quantize_loaded(loaded, batches, fp_box=args.int8_fp_box,
                                 mode=args.int8_calib_mode,
                                 npz_names=(qnpz.name,) if cached else ())
        if cached:
            print(f"Loaded int8 quant tree <- {qnpz}")
        else:
            print(f"Calibrated on {len(taken)} train batches ({args.int8_calib_mode}); "
                  f"saved -> {qnpz}")
        quantization = "int8_w8a8_ptq_fp_box" if args.int8_fp_box else "int8_w8a8_ptq"

    metrics = evaluate_detector(
        iter(loader), make_inference_fn(loaded.model, loaded.variables),
        iou_threshold=args.nms_iou, max_det=args.max_det,
        use_nms=(family != "rtdetr"),  # the DETR family is NMS-free
        device=device)
    metrics = add_derived_speed_metrics(metrics)
    metrics["params_total"] = count_params(fp_model)
    # FLOPs of the fp graph (a property of the model, not of its serving path).
    metrics["flops_g"] = model_flops_g(fp_model, args.img_h, args.img_w)
    if args.int8:
        metrics["quantization"] = quantization

    out_dir = Path(paths.EVAL_DIR) / args.backend / args.run_name
    out_dir.mkdir(parents=True, exist_ok=True)
    out_json = save_metrics_json(metrics, out_dir / "metrics.json")
    out_csv = save_metrics_table_csv(metrics, out_dir / "metrics_table.csv")
    metadata = {
        "model_family": family,
        "model_variant": variant or infer_model_variant_from_weights(str(ckpt_path)),
        "model_weights": str(ckpt_path),
        "run_name": args.run_name,
        "seed": int(args.seed),
        "split": args.split,
        "img_h": int(args.img_h),
        "img_w": int(args.img_w),
        "unclear_policy": args.unclear_policy,
        "dataset_export_name": Path(args.parquet).stem,
        "nms_iou": args.nms_iou,
        "max_det": args.max_det,
        "quantization": quantization,
    }
    metadata.update(collect_runtime_info())
    meta_json, meta_csv = save_run_metadata_artifacts(
        metadata, out_dir / "run_metadata.json", out_dir / "run_metadata.csv")
    print(f"Saved metrics -> {out_json}")
    print(f"Saved table   -> {out_csv}")
    print(f"Saved run metadata -> {meta_json}")
    print(f"Saved metadata table -> {meta_csv}")


if __name__ == "__main__":
    main()
