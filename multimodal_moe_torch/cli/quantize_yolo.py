"""Convert a trained detector run to the int8 PTQ serving format, on the
card.

The counterpart of the JAX package's ``scripts/quantize_yolo.py``, with its
flags, defaults and output: calibrate the activation scales on train-split
batches, fold BatchNorm, quantize the weights per channel, and write the
quant tree as ``int8_quant_<ckpt>.npz`` beside the checkpoint (or
``--out``), in the layout JAX's ``quant.load_quant_npz`` reads. The family
comes from ``model_config.json`` (yolo: the full conv trunk; moe: the trunk
and the w8a8 expert sweep; rtdetr: the backbone and the CCFF encoder convs).
``eval_detector --int8`` does the same conversion inline and caches it.

Unlike JAX's script, which restores the whole train state (``restore``),
this one restores without the optimizer state (``restore_eval``, as
``loading.load_detector`` does): the npz reads no optimizer slot, and a run
whose checkpoint carries none (converted from a JAX checkpoint saved
without one) quantizes too.
``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.quantize_yolo --weights outputs/runs/yolo/<run>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import paths


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="PTQ int8 conversion for a YOLO run.")
    p.add_argument("--weights", type=str, required=True,
                   help="Run dir (with weights/best) or checkpoint dir.")
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--splits-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--calib-batches", type=int, default=8)
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--out", type=str, default=None,
                   help="Output npz (default: int8_quant_<ckpt>.npz beside it).")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from .. import quant as qz
    from ..loading import build_detector, load_detector
    from ._common import cli_device
    from .eval_detector import calib_batches

    loaded = load_detector(args.weights, checkpoint=args.checkpoint, img_h=args.img_h,
                           img_w=args.img_w, use_ema=args.use_ema, device=cli_device())
    calib = list(calib_batches(args, args.calib_batches))
    _, model_q = build_detector(loaded.model_cfg, int8=True)
    qvars = qz.quantize_detector(loaded.model, model_q, calib)
    ckpt_path = loaded.ckpt_path
    out = Path(args.out) if args.out else ckpt_path.parent / f"int8_quant_{ckpt_path.name}.npz"
    qz.save_quant_npz(out, qvars)
    print(f"Calibrated on {len(calib)} batches @ {args.img_h}x{args.img_w}; "
          f"{len(qz.flatten(qvars))} quant leaves -> {out}")


if __name__ == "__main__":
    main()
