#!/usr/bin/env python3
"""Convert a run dir of the JAX package (Orbax checkpoints) into a run dir
of the PyTorch port.

    python tools/orbax_to_torch.py --weights <JAX run dir> --out <port run dir>

For each of ``weights/best`` and ``weights/last`` that exists, the Orbax
checkpoint is restored raw, as ``CheckpointManager.restore_eval`` of the
JAX package restores it (``params``, ``ema_params``, ``batch_stats``,
``step``, ``opt_state``). ``params`` with ``batch_stats``, and the EMA
parameters, go through ``convert.flax_to_state_dict``; the port's model,
built from the run's ``model_config.json`` by ``loading.build_detector``,
takes them strictly, so an unknown or missing leaf raises. The result is
written in the layout of the port's ``CheckpointManager``
(``weights/<name>/state.pt``), beside a copy of ``model_config.json`` and of
any ``int8_quant*.npz`` (the port reads JAX's npz files as they are).

The optimizer state is not converted: the converted checkpoint serves,
evaluates and predicts (``loading.load_detector`` reads it through
``restore_eval``), and the port's ``CheckpointManager.restore``, which a
resumed training run needs, refuses it.

This tool imports both packages, so it runs where the JAX package runs
(Flax and Orbax installed); the converted run dir is then carried to the
card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CHECKPOINTS = ("best", "last")


def convert_checkpoint(ckpt: Path, model_cfg: dict) -> dict:
    """One Orbax checkpoint → the port's checkpoint dict (``step``,
    ``model``, ``ema_params``; no ``opt_state``)."""
    import numpy as np
    import orbax.checkpoint as ocp

    from multimodal_moe_torch.convert import flax_to_state_dict
    from multimodal_moe_torch.loading import build_detector
    from multimodal_moe_torch.train.state import _copy_into

    raw = ocp.StandardCheckpointer().restore(ckpt.resolve())
    _, model = build_detector(model_cfg)
    model.load_state_dict(flax_to_state_dict(
        {"params": raw["params"], "batch_stats": raw.get("batch_stats") or {}}), strict=True)
    # the EMA into copies of the parameters, as restore_eval will load it
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    _copy_into(ema, flax_to_state_dict({"params": raw["ema_params"]}))
    return {"step": int(np.asarray(raw["step"])), "model": model.state_dict(),
            "ema_params": ema}


def convert_run(weights: Path, out: Path) -> "list[Path]":
    """Convert the run dir ``weights`` into ``out``; return the checkpoint
    directories written."""
    from multimodal_moe_torch.train.state import CheckpointManager

    weights, out = Path(weights), Path(out)
    cfg_path = weights / "model_config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(f"{cfg_path} is missing")
    model_cfg = json.loads(cfg_path.read_text())
    names = [n for n in CHECKPOINTS if (weights / "weights" / n).exists()]
    if not names:
        raise FileNotFoundError(f"no weights/best or weights/last under {weights}")
    out.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(cfg_path, out / "model_config.json")
    manager = CheckpointManager(out / "weights")
    written = []
    for name in names:
        state = convert_checkpoint(weights / "weights" / name, model_cfg)
        written.append(manager.save(name, SimpleNamespace(state_dict=lambda s=state: s)))
    for npz in sorted((weights / "weights").glob("int8_quant*.npz")):
        shutil.copyfile(npz, out / "weights" / npz.name)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", type=Path, required=True,
                   help="Run dir of the JAX package (model_config.json, weights/best|last).")
    p.add_argument("--out", type=Path, required=True, help="Run dir of the port to write.")
    args = p.parse_args(argv)
    for path in convert_run(args.weights, args.out):
        print(f"[convert] {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
