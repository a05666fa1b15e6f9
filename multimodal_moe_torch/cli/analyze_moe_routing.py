"""Expert-routing-by-context analysis of a trained MoE-YOLO checkpoint, on
the card.

The counterpart of the JAX package's ``scripts/analyze_moe_routing.py``,
with its flags, defaults and output: how the trained router splits tokens
across experts per solar context (``expert_load``, ``(levels, E)``, of the
EMA weights in eval mode, over the first ``--per-context`` frames of every
bin that has that many), the pairwise L1 divergence of those loads per
level, and a counterfactual (the first bin's images with every other bin's
context id) that isolates the additive context-bias term from
content-driven routing. Writes ``routing_by_context.json`` and
``routing_report.md`` under ``--out-dir`` (default
``$OUTPUTS_DIR/analysis/moe_routing/<run-name>/``), with JAX's keys and
layout.

The checkpoint is read by ``CheckpointManager.restore_eval`` (parameters,
EMA, running statistics), as ``cli/quantize_yolo.py`` reads it, so a run
dir converted by ``tools/orbax_to_torch.py`` works too; JAX's structural
``restore`` reads the same weights. ``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.analyze_moe_routing --weights outputs/runs/moe/<run>
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import paths


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Analyze MoE routing by context.")
    p.add_argument("--weights", required=True,
                   help="MoE run dir (with weights/best + model_config.json).")
    p.add_argument("--parquet", type=str,
                   default=str(paths.ZODMOE_FRAMES_WITH_BOXES_AND_SOLAR_BINS_PARQUET))
    p.add_argument("--splits-dir", type=str, default=str(paths.SPLITS_DIR))
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--per-context", type=int, default=16,
                   help="Images sampled per context bin.")
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--out-dir", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from ..data.pipeline import ZODMoEDataConfig, ZODMoEVisionDataset
    from ..data.solar import SOLAR_BIN_TO_ID
    from ..models.moe_yolo import MoEYoloDetector
    from ..train.detection import DetectionTrainer, DetTrainConfig
    from ..train.state import CheckpointManager
    from ._common import cli_device

    run_dir = Path(args.weights).resolve()
    cfg = json.loads((run_dir / "model_config.json").read_text())
    model = MoEYoloDetector(num_classes=cfg.get("num_classes", 1),
                            variant=cfg.get("variant", "s"),
                            num_experts=cfg.get("num_experts", 4))
    trainer = DetectionTrainer(
        model,
        DetTrainConfig(variant=cfg.get("variant", "s"), img_h=args.img_h, img_w=args.img_w,
                       optimizer=cfg.get("optimizer", "sgd")),
        steps_per_epoch=1, device=cli_device())
    state = trainer.init_state()
    state = CheckpointManager(run_dir / "weights").restore_eval(args.checkpoint, state)
    # The EMA weights with the checkpoint's running statistics, in eval mode.
    model = state.model.eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    device = trainer.device

    split_csv = Path(args.splits_dir) / f"{args.split}_ids.csv"
    ds = ZODMoEVisionDataset(ZODMoEDataConfig(
        frames_parquet=args.parquet, split_csv=str(split_csv),
        img_h=args.img_h, img_w=args.img_w,
    ))
    df = ds.df
    id_to_idx = {fid: i for i, fid in enumerate(df["frame_id"].tolist())}

    def fwd(imgs, ctx) -> np.ndarray:
        with torch.inference_mode():
            return model(imgs, train=False, context_ids=ctx)["expert_load"].float().cpu().numpy()

    def load_imgs(fids):
        imgs, ctxs = [], []
        for fid in fids:
            s = ds.load(id_to_idx[fid])
            imgs.append(s["image"])
            ctxs.append(s["solar_bin"])
        return (torch.from_numpy(np.stack(imgs)).to(device).float() / 255.0,
                torch.from_numpy(np.array(ctxs, np.int32)).to(device))

    counts = df["solar_context_bin"].value_counts()
    bins = [b for b in counts.index if counts[b] >= args.per_context
            and str(b) in SOLAR_BIN_TO_ID]
    loads: "dict[str, np.ndarray]" = {}
    for b in bins:
        fids = df[df.solar_context_bin == b].frame_id.iloc[: args.per_context]
        loads[str(b)] = fwd(*load_imgs(list(fids)))

    # pairwise L1 divergence of per-level expert load distributions
    names = list(loads)
    divergence = {
        f"{a} vs {b}": np.abs(loads[a] - loads[b]).sum(-1).tolist()
        for i, a in enumerate(names) for b in names[i + 1:]
    }

    # counterfactual: first bin's images with every other context id —
    # isolates the additive router bias from image content
    counterfactual = {}
    if names:
        fids = df[df.solar_context_bin == names[0]].frame_id.iloc[: args.per_context]
        imgs, ctx = load_imgs(list(fids))
        for b in names[1:]:
            el = fwd(imgs, torch.full_like(ctx, SOLAR_BIN_TO_ID[b]))
            counterfactual[f"{names[0]} imgs as {b} ctx"] = (
                np.abs(el - loads[names[0]]).sum(-1).tolist()
            )

    out_dir = Path(args.out_dir) if args.out_dir else (
        paths.ANALYSIS_DIR / "moe_routing" / run_dir.name
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "run": str(run_dir),
        "split": args.split,
        "per_context": args.per_context,
        "expert_load_by_context": {k: v.tolist() for k, v in loads.items()},
        "l1_divergence_per_level": divergence,
        "counterfactual_ctx_shift_per_level": counterfactual,
    }
    (out_dir / "routing_by_context.json").write_text(json.dumps(payload, indent=2))

    lines = [f"# MoE routing by context — {run_dir.name}", ""]
    lines.append("Per-level expert load fraction (rows = levels P3/P4/P5):\n")
    for k, v in loads.items():
        lines.append(f"**{k}**\n```\n{np.round(v, 3)}\n```")
    lines.append("\nL1 divergence per level:\n")
    for k, v in divergence.items():
        lines.append(f"- {k}: {[round(x, 3) for x in v]}")
    lines.append("\nCounterfactual context swap (bias-term isolation):\n")
    for k, v in counterfactual.items():
        lines.append(f"- {k}: {[round(x, 3) for x in v]}")
    (out_dir / "routing_report.md").write_text("\n".join(lines) + "\n")
    print(f"Wrote {out_dir}/routing_by_context.json and routing_report.md")


if __name__ == "__main__":
    main()
