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

The optimizer state becomes the port's ``Optimizer.state``
(:func:`optimizer_state`), so a converted run resumes (``--resume``, the
port's ``CheckpointManager.restore``). JAX's chain
(``multimodal_moe_tpu/train/state.py:make_optimizer``) is
``clip_by_global_norm`` (empty), then ``add_decayed_weights`` +
``sgd(nesterov)`` (a ``TraceState``) or ``adamw`` (``ScaleByAdamState``:
``count``, ``mu``, ``nu``), then the schedule's ``ScaleByScheduleState``
(``count``); Orbax restores its tuples as lists, its named tuples as dicts
and the empty states as None. ``mu``, ``nu`` and ``trace`` take their
parameters' leaf mapping (HWIO → OIHW, ``Dense`` kernels transposed, the
MoE's raw leaves as they are); every ``count`` must equal ``step``, and a
node the walk does not know, or a leaf it cannot place, raises. A
checkpoint saved without ``opt_state`` converts without it, and then only
serves and evaluates (``restore_eval``).

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


OPT_SLOTS = {"mu": "adamw", "nu": "adamw", "trace": "sgd"}


def optimizer_state(opt_state, step: int, param_names) -> dict:
    """Orbax's raw ``opt_state`` of JAX's chain → the port's
    ``Optimizer.state`` (``{"count", "mu", "nu"}`` for AdamW, ``{"count",
    "trace"}`` for SGD), keyed by the torch names ``param_names``."""
    import numpy as np

    from multimodal_moe_torch.convert import flax_to_state_dict

    counts, slots = [], {}

    def walk(node, path):
        if node is None:                         # optax's EmptyState
            return
        if hasattr(node, "_asdict"):             # a named tuple, before Orbax
            node = node._asdict()
        if isinstance(node, dict):
            for key, value in node.items():
                where = path + (str(key),)
                if key == "count":
                    if np.ndim(value) != 0:
                        raise ValueError(f"opt_state {'/'.join(where)} is not a scalar")
                    counts.append(("/".join(where), int(np.asarray(value))))
                elif key in OPT_SLOTS:
                    if key in slots:
                        raise ValueError(f"opt_state holds two {key!r} trees")
                    slots[key] = value
                elif key == "inner_state":       # MaskedState
                    walk(value, where)
                else:
                    raise ValueError(f"unknown optimizer state node {'/'.join(where)}")
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, path + (str(i),))
        else:
            raise ValueError(f"optimizer state leaf {'/'.join(path) or '<root>'} has no place "
                             f"in the port's state ({type(node).__name__})")

    walk(opt_state, ())
    kinds = {OPT_SLOTS[k] for k in slots}
    if len(kinds) != 1 or (kinds == {"adamw"} and set(slots) != {"mu", "nu"}):
        raise ValueError(f"opt_state holds {sorted(slots)}: neither AdamW (mu, nu) nor SGD (trace)")
    if not counts:
        raise ValueError("opt_state holds no count")
    wrong = [(where, c) for where, c in counts if c != step]
    if wrong:
        raise ValueError(f"opt_state counts {wrong} disagree with step {step}")
    state = {"count": step}
    names = set(param_names)
    for key, tree in slots.items():
        sd = {k: v.float() for k, v in flax_to_state_dict({"params": tree}).items()}
        if set(sd) != names:
            raise ValueError(f"opt_state {key!r} leaves differ from the parameters: missing "
                             f"{sorted(names - set(sd))[:5]}, unknown {sorted(set(sd) - names)[:5]}")
        state[key] = sd
    return state


def convert_checkpoint(ckpt: Path, model_cfg: dict) -> dict:
    """One Orbax checkpoint → the port's checkpoint dict (``step``,
    ``model``, ``ema_params`` and, where the checkpoint has one,
    ``opt_state``)."""
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
    step = int(np.asarray(raw["step"]))
    out = {"step": step, "model": model.state_dict(), "ema_params": ema}
    if raw.get("opt_state") is not None:
        out["opt_state"] = optimizer_state(raw["opt_state"], step, ema)
    return out


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
