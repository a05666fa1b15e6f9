"""Train state, the optimizer chain, the EMA and best/last checkpoints.

Counterpart of ``multimodal_moe_tpu/train/state.py``. The optimizer is the
optax chain of ``make_optimizer`` written out over named tensors, with
optax's arithmetic: a learning rate of linear warmup from 0 then linear
decay to ``lr0·lrf`` (optax counts from 0, so the first update has lr 0);
``clip_by_global_norm`` (``(g / ‖g‖)·max_norm`` where ‖g‖ ≥ max_norm, no
epsilon, unlike ``torch.nn.utils.clip_grad_norm_``); then SGD with Nesterov
momentum after the decoupled decay, or AdamW. Weight decay reaches the
leaves whose Flax path holds ``kernel`` and whose rank is above 1
(``_decay_mask``), read from the module types: Linear and Conv weights and
raw ``*kernel`` parameters, never biases, norm scales or
``dn_content_embed``. Checkpoints are ``torch.save`` files in the JAX
layout of directories (``weights/last``, ``weights/best``) with the same
crash-safe ``.new``/``.old`` swap.

On a mesh (``parallel.mesh``) a rank holds its shard of every
``experts_*`` tensor: ``clip_by_global_norm`` adds the shards' squared
norms over the expert group, so it clips by the norm of the whole
parameter set; checkpoints gather the shards first and rank 0 writes the
one-process layout, fenced by barriers as JAX's process 0 is (a run on any
mesh, or none, reads any of them).
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import EXPERT_AXIS, Mesh, barrier, gather_params, is_expert, shard_params

# Flax leaf name of a torch parameter, by the type of the module holding it.
_KERNEL_MODULES = (nn.Linear, nn.Conv2d)
_SCALE_MODULES = (nn.LayerNorm, nn.BatchNorm2d)


def flax_leaf_path(model: nn.Module, name: str) -> str:
    """The Flax path (``a/b/kernel``) of the torch parameter ``name``: a
    Linear or Conv ``weight`` is a ``kernel``, a norm's ``weight`` a
    ``scale``; biases and raw parameters keep their names."""
    mod_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_name) if mod_name else model
    if leaf == "weight" and isinstance(module, _KERNEL_MODULES):
        leaf = "kernel"
    elif leaf == "weight" and isinstance(module, _SCALE_MODULES):
        leaf = "scale"
    return "/".join(mod_name.split(".") + [leaf]) if mod_name else leaf


def decay_mask(model: nn.Module) -> "Dict[str, bool]":
    """``_decay_mask`` of the JAX module, over the torch parameter names."""
    return {name: "kernel" in flax_leaf_path(model, name) and p.dim() > 1
            for name, p in model.named_parameters()}


def make_schedule(lr0: float, lrf: float, warmup_steps: int,
                  total_steps: int) -> "Callable[[int], float]":
    """optax ``join_schedules`` of two ``linear_schedule``s, in float32:
    0 → lr0 over ``warmup_steps``, then lr0 → lr0·lrf."""
    decay_steps = max(total_steps - warmup_steps, 1)
    f32 = np.float32

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        frac = f32(1) - f32(count) / f32(steps)
        return (f32(init) - f32(end)) * frac + f32(end)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(linear(0.0, lr0, warmup_steps, count))
        return float(linear(lr0, lr0 * lrf, decay_steps, count - warmup_steps))

    return schedule


class Optimizer:
    """The optimizer chain of ``make_optimizer`` over ``params`` (name →
    tensor, updated in place). ``state`` holds optax's: the update count and
    Adam's ``mu``/``nu`` or SGD's momentum ``trace``."""

    def __init__(self, params: "Dict[str, torch.Tensor]", decayed: "Dict[str, bool]", *,
                 lr0: float = 0.01, lrf: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, warmup_steps: int = 1000,
                 total_steps: int = 10000, optimizer: str = "sgd",
                 grad_clip_norm: Optional[float] = 10.0, mesh: "Optional[Mesh]" = None):
        if optimizer not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer: {optimizer}")
        warmup_steps = max(1, min(warmup_steps, max(total_steps - 1, 1)))
        self.params = params
        self.decayed = decayed
        self.schedule = make_schedule(lr0, lrf, warmup_steps, total_steps)
        self.kind, self.momentum, self.weight_decay = optimizer, momentum, weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.mesh = mesh
        slots = ("mu", "nu") if optimizer == "adamw" else ("trace",)
        self.state: "Dict[str, object]" = {"count": 0}
        for slot in slots:
            self.state[slot] = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: "Dict[str, torch.Tensor]") -> None:
        """One update, with each elementwise stage over all tensors at once
        (``torch._foreach_*``: the same float operations as a loop over
        the tensors, a few launches instead of thousands)."""
        count = int(self.state["count"])
        names = list(self.params)
        params = [self.params[k] for k in names]
        g = [grads[k] for k in names]
        if self.grad_clip_norm is not None:
            norm = global_norm(g) if not _expert_sharded(self.mesh) else _sharded_norm(
                g, [is_expert(k) for k in names], self.mesh)
            if not bool(norm < self.grad_clip_norm):
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.grad_clip_norm)
        lr = self.schedule(count)
        decayed = [i for i, k in enumerate(names) if self.decayed[k]]
        wd = self.weight_decay
        if self.kind == "adamw":
            b1, b2, eps = 0.9, 0.999, 1e-8
            c1 = float(1 - np.float32(b1) ** np.float32(count + 1))
            c2 = float(1 - np.float32(b2) ** np.float32(count + 1))
            mu = [self.state["mu"][k] for k in names]
            nu = [self.state["nu"][k] for k in names]
            torch._foreach_mul_(mu, b1)                         # b1·mu + (1 − b1)·g
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)                         # b2·nu + (1 − b2)·g²
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            u = list(torch._foreach_div(torch._foreach_div(mu, c1), denom))
        else:
            if decayed:
                g = list(g)
                dec = torch._foreach_add([g[i] for i in decayed],
                                         torch._foreach_mul([params[i] for i in decayed], wd))
                for i, t in zip(decayed, dec):
                    g[i] = t
            trace = [self.state["trace"][k] for k in names]
            torch._foreach_mul_(trace, self.momentum)           # g + m·trace
            torch._foreach_add_(trace, g)
            u = torch._foreach_add(g, torch._foreach_mul(trace, self.momentum))  # Nesterov
            decayed = []
        if decayed:
            dec = torch._foreach_add([u[i] for i in decayed],
                                     torch._foreach_mul([params[i] for i in decayed], wd))
            for i, t in zip(decayed, dec):
                u[i] = t
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))
        self.state["count"] = count + 1

    def state_dict(self) -> dict:
        return {k: (dict(v) if isinstance(v, dict) else v) for k, v in self.state.items()}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd) != set(self.state):
            raise ValueError(f"optimizer state has {sorted(sd)}, expected {sorted(self.state)}")
        for k, v in sd.items():
            if isinstance(v, dict):
                for name, t in v.items():
                    self.state[k][name].copy_(t)
            else:
                self.state[k] = int(v)


@dataclass
class TrainState:
    """``step``, the model (its parameters are ``params``, its BatchNorm
    running averages ``batch_stats``), the optimizer and its state, and the
    EMA of the parameters."""

    step: int
    model: nn.Module
    opt: Optimizer
    ema_params: "Dict[str, torch.Tensor]"

    @property
    def params(self) -> "Dict[str, torch.Tensor]":
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> "Dict[str, torch.Tensor]":
        return {k: v for k, v in self.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    @torch.no_grad()
    def apply_gradients(self, grads: "Dict[str, torch.Tensor]") -> "TrainState":
        """One optimizer update, then the EMA with its warmup ramp
        ``0.9999·(1 − exp(−step/2000))`` over the parameters only (the
        running averages are not averaged; evaluation pairs ``ema_params``
        with the live ``batch_stats``)."""
        self.opt.step(grads)
        self.step += 1
        f32 = np.float32
        decay = f32(0.9999) * (f32(1) - np.exp(-f32(self.step) / f32(2000.0)))
        keep, take = float(decay), float(f32(1) - decay)
        names, params = zip(*self.model.named_parameters())
        ema = [self.ema_params[k] for k in names]
        torch._foreach_mul_(ema, keep)                          # e·decay + p·(1 − decay)
        torch._foreach_add_(ema, torch._foreach_mul(list(params), take))
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt.state_dict(), "ema_params": dict(self.ema_params)}


def make_train_state(model: nn.Module, mesh: "Optional[Mesh]" = None,
                     **optimizer_kw) -> TrainState:
    """Step 0, the optimizer over ``model``'s parameters with the decay mask
    of its Flax paths, and the EMA as a copy of the parameters (on a
    ``mesh``, of this rank's shards)."""
    params = dict(model.named_parameters())
    opt = Optimizer(params, decay_mask(model), mesh=mesh, **optimizer_kw)
    ema = {k: p.detach().clone() for k, p in params.items()}
    return TrainState(step=0, model=model, opt=opt, ema_params=ema)


def _tensor_dicts(sd: dict, fn: Callable) -> dict:
    """``fn`` over each tensor dict of a state dict: the model, the EMA and
    every optimizer slot."""
    out = dict(sd)
    for key in ("model", "ema_params"):
        if key in sd:
            out[key] = fn(sd[key])
    if "opt_state" in sd:
        out["opt_state"] = {k: fn(v) if isinstance(v, dict) else v
                            for k, v in sd["opt_state"].items()}
    return out


def one_process_state_dict(state: TrainState, mesh: "Optional[Mesh]" = None) -> dict:
    """``state.state_dict()`` in the one-process layout: on a mesh, every
    expert shard (parameters, EMA, optimizer slots) gathered over the
    expert group, a collective every rank calls."""
    sd = state.state_dict()
    if not _expert_sharded(mesh):
        return sd
    return _tensor_dicts(sd, lambda d: gather_params(d, mesh))


# ---------------------------------------------------------------------------
# best/last checkpoints
# ---------------------------------------------------------------------------

class CheckpointManager:
    """best/last checkpoints with resume, each a directory holding
    ``state.pt`` (``TrainState.state_dict``), read back with
    ``weights_only=True``.

    With a ``mesh`` every rank calls ``save``, ``restore``, ``restore_eval``
    and ``has`` in the same order: ``save`` gathers the expert shards (a
    collective) and rank 0 writes, ``restore`` slices them back on every
    rank; the file bookkeeping (stale cleanup, the swap, recovery) runs on
    rank 0, between barriers."""

    FILE = "state.pt"

    def __init__(self, run_dir: "str | Path", mesh: "Optional[Mesh]" = None):
        self.run_dir = Path(run_dir).resolve()
        self.mesh = mesh
        if self._is_lead():
            self.run_dir.mkdir(parents=True, exist_ok=True)
        barrier(mesh)

    def _path(self, name: str) -> Path:
        return self.run_dir / name

    def _is_lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save(self, name: str, state: TrainState) -> Path:
        """Crash-safe save: write ``<name>.new``, then swap it in through
        ``<name>.old``; a crash between the two renames is repaired by
        ``_recover``."""
        path, new, old = self._path(name), self._path(name + ".new"), self._path(name + ".old")
        sd = one_process_state_dict(state, self.mesh)
        if self._is_lead():
            for stale in (new, old):
                if stale.exists():
                    shutil.rmtree(stale)
            new.mkdir()
            torch.save(sd, new / self.FILE)
            if path.exists():
                path.rename(old)
            new.rename(path)
            if old.exists():
                shutil.rmtree(old)
        barrier(self.mesh)
        return path

    def _recover(self, name: str) -> None:
        """``<name>`` missing and a fully written ``<name>.new`` present (a
        crash between the swap's renames): finish the swap."""
        path, new = self._path(name), self._path(name + ".new")
        if self._is_lead() and not path.exists() and (new / self.FILE).exists():
            new.rename(path)
        barrier(self.mesh)

    def save_last(self, state: TrainState) -> Path:
        return self.save("last", state)

    def save_best(self, state: TrainState) -> Path:
        return self.save("best", state)

    def _load(self, name: str) -> dict:
        self._recover(name)
        raw = torch.load(self._path(name) / self.FILE, map_location="cpu", weights_only=True)
        if not _expert_sharded(self.mesh):
            return raw
        return _tensor_dicts(raw, lambda d: shard_params(d, self.mesh))   # this rank's shards

    def restore(self, name: str, target: TrainState) -> TrainState:
        """The whole state, optimizer included, into ``target`` (a run dir
        converted from JAX by ``tools/orbax_to_torch.py`` carries JAX's
        optimizer state too). A checkpoint without optimizer state (one
        converted from a JAX checkpoint saved without it) raises
        ``ValueError``: it serves and evaluates through :meth:`restore_eval`,
        but cannot resume training."""
        raw = self._load(name)
        if "opt_state" not in raw:
            raise ValueError(
                f"{self._path(name)} holds no optimizer state (converted by "
                "tools/orbax_to_torch.py from a checkpoint without one); it cannot resume "
                "training, restore_eval reads it")
        target.model.load_state_dict(raw["model"], strict=True)
        target.opt.load_state_dict(raw["opt_state"])
        _copy_into(target.ema_params, raw["ema_params"])
        target.step = int(raw["step"])
        return target

    def restore_eval(self, name: str, target: TrainState) -> TrainState:
        """Only what inference reads (parameters, ``ema_params``, running
        averages); the optimizer state is ignored, so a checkpoint of any
        optimizer restores into a state built for another."""
        raw = self._load(name)
        target.model.load_state_dict(raw["model"], strict=True)
        _copy_into(target.ema_params, raw["ema_params"])
        return target

    def has(self, name: str) -> bool:
        self._recover(name)
        return self._path(name).exists()


def _copy_into(dst: "Dict[str, torch.Tensor]", src: "Dict[str, torch.Tensor]") -> None:
    if set(dst) != set(src):
        raise ValueError("checkpoint EMA keys differ from the model's parameters")
    with torch.no_grad():
        for k, t in src.items():
            dst[k].copy_(t)


def _expert_sharded(mesh: "Optional[Mesh]") -> bool:
    return mesh is not None and mesh.num_expert > 1


def _sharded_norm(tensors, sharded, mesh: Mesh) -> torch.Tensor:
    """:func:`global_norm` of the whole parameter set from a rank's view:
    the squared norms of the expert shards summed over the expert group."""
    squares = torch.stack(torch._foreach_norm(list(tensors))) ** 2
    mask = torch.tensor(sharded, device=squares.device)
    experts = mesh.all_reduce(squares[mask].sum()[None], EXPERT_AXIS)[0]
    return (squares[~mask].sum() + experts).sqrt()


def global_norm(tensors: "Iterable[torch.Tensor]") -> torch.Tensor:
    """optax ``global_norm``: the 2-norm of all elements together (each
    tensor's norm in one multi-tensor launch, then the norm of those)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))

