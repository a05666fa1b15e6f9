"""Train the context-routed MoE-YOLO detector on the card.

The counterpart of the JAX package's ``scripts/train_moe.py``: train_yolo's
data and protocol defaults and run dir (``cli/_train.py``), with the MoE
flags (experts, top-k, capacity factor) and ``--expert-parallel``, the
mesh's expert axis. ``model_config.json`` records, beside ``dispatch:
auto``, the mode each level resolves to at the training batch
(``models.moe.resolve_dispatch``). ``MMOE_PLATFORM=cpu`` runs on the CPU.

    python -m multimodal_moe_torch.cli.train_moe --variant s --resident
"""

from __future__ import annotations

import argparse

from ._train import REMAT_HELP, add_run_args


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train context-routed MoE detector.")
    p.add_argument("--variant", type=str, default="s", help="trunk size n/s/m/l")
    add_run_args(p, epochs=50, lr0=0.01, project="moe")
    p.add_argument("--num-experts", type=int, default=4)
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="ranks on the mesh's expert axis")
    p.add_argument("--remat", action="store_true", help=REMAT_HELP)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from ..models.moe import resolve_dispatch
    from ..models.moe_yolo import MoEYoloDetector, moe_yolo_loss
    from ..train.detection import DetTrainConfig
    from ._train import train

    model = MoEYoloDetector(num_classes=1, variant=args.variant, num_experts=args.num_experts,
                            k=args.top_k, capacity_factor=args.capacity_factor,
                            remat=args.remat)
    cfg = DetTrainConfig(variant=args.variant, img_h=args.img_h, img_w=args.img_w,
                         epochs=args.epochs, patience=args.patience, batch=args.batch,
                         seed=args.seed, lr0=args.lr0)
    # The mode "auto" resolves to at each level, at the training batch: the
    # thresholds may move between versions, and the modes' numerics differ.
    effective = {
        f"P{3 + i}": resolve_dispatch("auto", args.batch * (args.img_h // s) * (args.img_w // s),
                                      args.num_experts)
        for i, s in enumerate((8, 16, 32))
    }
    train(
        args, model=model, cfg=cfg, loss_fn=moe_yolo_loss, num_expert=args.expert_parallel,
        model_config={"family": "moe", "variant": args.variant, "num_classes": 1,
                      "num_experts": args.num_experts, "top_k": args.top_k, "optimizer": "sgd",
                      "img_h": args.img_h, "img_w": args.img_w, "dispatch": "auto",
                      "effective_dispatch_at_train_batch": effective},
        model_name=f"moe-yolo-{args.variant}-e{args.num_experts}",
        metadata={"model_family": "moe",
                  "model_variant": f"{args.variant}-e{args.num_experts}k{args.top_k}"},
        metadata_extra={"num_experts": args.num_experts,
                        "expert_parallel": args.expert_parallel})


if __name__ == "__main__":
    main()
