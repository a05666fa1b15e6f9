"""The ``(data, expert)`` mesh of ranks, its batch and parameter layout,
and its collectives.

Counterpart of ``multimodal_moe_tpu/parallel/mesh.py``. JAX lays devices
out as ``reshape(num_data, num_expert)``; here rank ``d·num_expert + e``
sits at ``(d, e)``. The layout matches JAX's shardings:

* a batch splits its leading dimension over both axes (``P((data,
  expert))``): rank ``r`` holds the ``r``-th contiguous block
  (:func:`batch_slice`);
* ``experts_*`` parameters split their leading (expert) dimension over the
  expert axis (``P(expert)``): rank ``(d, e)`` holds experts ``[e·E/n_e,
  (e+1)·E/n_e)`` (:func:`shard_params`); everything else is replicated.

The trainer enters :func:`use_mesh` around the step, the counterpart of
``jax.sharding.set_mesh``; the model code reads :func:`active_mesh` and
makes its batch reductions global. Outside it, and on a 1×1 mesh,
``active_mesh()`` is None and every function is the single-process one.

The collectives are built on ``all_reduce`` and ``broadcast`` only (gloo
runs those two on CUDA tensors, NCCL runs everything), so the same code
runs on both backends. A gather is an ``all_reduce`` of a zero buffer in
which each rank fills its own rows: exact, since x + 0 = x. The
differentiable ``all_reduce`` (:func:`all_reduce`) sums the gradients over
the group in its backward, as ``torch.distributed.nn.functional.all_reduce``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
EXPERT_TOKEN = "experts"   # a parameter whose name holds this is expert-stacked


class Mesh:
    """A ``num_data × num_expert`` mesh and this rank's place in it.

    ``rank = d·num_expert + e``. ``world_group`` is every rank,
    ``data_group`` the ranks of this ``e`` (one expert shard, all data
    shards), ``expert_group`` the ranks of this ``d``. A mesh made for a
    world that is not the initialized process group (``create_mesh(...,
    world_size=, rank=)``) is a layout only: its groups are None and its
    collectives raise."""

    def __init__(self, num_data: int, num_expert: int, rank: int, groups=None):
        self.num_data, self.num_expert, self.rank = num_data, num_expert, rank
        self.d, self.e = divmod(rank, num_expert)
        self.world_group, self.data_group, self.expert_group = groups or (None, None, None)

    @property
    def shape(self) -> "Dict[str, int]":
        return {DATA_AXIS: self.num_data, EXPERT_AXIS: self.num_expert}

    @property
    def size(self) -> int:
        return self.num_data * self.num_expert

    def __repr__(self) -> str:
        return f"Mesh({self.num_data}x{self.num_expert}, rank={self.rank})"

    def group(self, axis: str):
        """The group of ``axis``: ``"world"``, ``"data"`` or ``"expert"``."""
        g = {"world": self.world_group, DATA_AXIS: self.data_group,
             EXPERT_AXIS: self.expert_group}[axis]
        if g is None and self.size > 1:
            raise RuntimeError(f"{self} is a layout without process groups "
                               "(torch.distributed is not initialized at its world size)")
        return g

    def axis_size(self, axis: str) -> int:
        return {"world": self.size, DATA_AXIS: self.num_data, EXPERT_AXIS: self.num_expert}[axis]

    def axis_index(self, axis: str) -> int:
        return {"world": self.rank, DATA_AXIS: self.d, EXPERT_AXIS: self.e}[axis]

    def all_reduce(self, x: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis`` (differentiable)."""
        return all_reduce(x, self.group(axis))

    def gather(self, x: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """The ranks' ``x`` of ``axis`` stacked along dim 0 in rank order
        (differentiable: each rank's rows get the sum of the gradients of
        their copies)."""
        n = self.axis_size(axis)
        i = self.axis_index(axis)
        rows = x.shape[0]
        buf = torch.cat([x.new_zeros((i * rows,) + x.shape[1:]), x,
                         x.new_zeros(((n - 1 - i) * rows,) + x.shape[1:])])
        return self.all_reduce(buf, axis)

    def own_rows(self, x: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """This rank's block of a tensor stacked over ``axis`` (the inverse
        of :meth:`gather`'s layout)."""
        rows = x.shape[0] // self.axis_size(axis)
        i = self.axis_index(axis)
        return x[i * rows:(i + 1) * rows]


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable where ``x`` needs a
    gradient; a new tensor, ``x`` is left alone."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllReduce.apply(x, group)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def create_mesh(num_data: Optional[int] = None, num_expert: int = 1, *,
                world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """A ``(data, expert)`` mesh over the ranks of the process group (one
    rank without one), with JAX's rule: ``num_data=None`` takes every rank
    the expert axis leaves. ``world_size`` and ``rank`` give a layout of
    another world (no groups unless it is the initialized one). Every rank
    of the group must call this, in the same order: it makes the groups."""
    initialized = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if initialized else 1)
    if num_data is None:
        if n % num_expert:
            raise ValueError(f"{n} devices not divisible by expert={num_expert}")
        num_data = n // num_expert
    if num_data * num_expert != n:
        raise ValueError(f"mesh {num_data}x{num_expert} != {n} devices")
    own = initialized and n == dist.get_world_size()
    if rank is None:
        rank = dist.get_rank() if own else 0
    groups = None
    if own:
        data_groups = [dist.new_group([d * num_expert + e for d in range(num_data)])
                       for e in range(num_expert)]
        expert_groups = [dist.new_group([d * num_expert + e for e in range(num_expert)])
                         for d in range(num_data)]
        d, e = divmod(rank, num_expert)
        groups = (dist.group.WORLD, data_groups[e], expert_groups[d])
    return Mesh(num_data, num_expert, rank, groups)


_ACTIVE: "Optional[Mesh]" = None


@contextlib.contextmanager
def use_mesh(mesh: "Optional[Mesh]") -> "Iterator[Optional[Mesh]]":
    """Make ``mesh`` the active mesh inside the block (the trainer's step)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active_mesh() -> "Optional[Mesh]":
    """The mesh of :func:`use_mesh`; None outside it and on a 1×1 mesh."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.size > 1 else None


def batch_slice(mesh: Mesh, b_global: int) -> slice:
    """This rank's rows of a global batch of ``b_global`` (JAX's
    ``P((data, expert))``: shard ``d·num_expert + e``, a contiguous block)."""
    if b_global % mesh.size:
        raise ValueError(f"a batch of {b_global} does not split over {mesh.size} ranks")
    n = b_global // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def is_expert(name: str) -> bool:
    return EXPERT_TOKEN in name


def expert_rows(mesh: Mesh, num_experts: int) -> slice:
    """The experts this rank holds: ``[e·E/n_e, (e+1)·E/n_e)``."""
    if num_experts % mesh.num_expert:
        raise ValueError(f"{num_experts} experts do not split over {mesh.num_expert} ranks")
    n = num_experts // mesh.num_expert
    return slice(mesh.e * n, (mesh.e + 1) * n)


def shard_params(params: "Dict[str, torch.Tensor]", mesh: Mesh) -> "Dict[str, torch.Tensor]":
    """This rank's view of a one-process tensor dict: the rows
    :func:`expert_rows` of every ``experts_*`` tensor, the rest as is."""
    if mesh.num_expert == 1:
        return dict(params)
    return {k: v[expert_rows(mesh, v.shape[0])] if is_expert(k) else v
            for k, v in params.items()}


def gather_params(params: "Dict[str, torch.Tensor]", mesh: Mesh) -> "Dict[str, torch.Tensor]":
    """The one-process tensor dict from this rank's view: every
    ``experts_*`` shard gathered over the expert group (a collective:
    every rank calls it)."""
    if mesh.num_expert == 1:
        return dict(params)
    with torch.no_grad():
        return {k: mesh.gather(v, EXPERT_AXIS) if is_expert(k) else v for k, v in params.items()}


def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every ``experts_*`` parameter of ``model`` by this rank's
    rows (in place)."""
    if mesh.num_expert == 1:
        return model
    for name, p in list(model.named_parameters()):
        if is_expert(name):
            mod_name, _, leaf = name.rpartition(".")
            module = model.get_submodule(mod_name) if mod_name else model
            rows = p.detach()[expert_rows(mesh, p.shape[0])].clone()
            setattr(module, leaf, nn.Parameter(rows, requires_grad=p.requires_grad))
    return model


@torch.no_grad()
def broadcast_module(model: nn.Module, mesh: Mesh, src: int = 0) -> nn.Module:
    """Every parameter and buffer of ``model`` from rank ``src`` (one
    broadcast a dtype)."""
    tensors = list(model.parameters()) + list(model.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src, group=mesh.group("world"))
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return model


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """``obj`` (picklable) of rank ``src`` on every rank of ``mesh``; as
    it is without process groups."""
    if mesh.world_group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=mesh.group("world"))
    return box[0]


@torch.no_grad()
def reduce_gradients(grads: "Dict[str, torch.Tensor]", mesh: Mesh) -> "Dict[str, torch.Tensor]":
    """Each gradient summed once over the ranks that hold its parameter:
    replicated tensors over the world group, ``experts_*`` shards over the
    data group (one ``all_reduce`` a kind and dtype, on a flat buffer). A
    mesh without process groups (one process) leaves them as they are."""
    out = dict(grads)
    if mesh.world_group is None:
        return out
    sharded = mesh.num_expert > 1
    for axis, names in (("world", [k for k in grads if not (sharded and is_expert(k))]),
                        (DATA_AXIS, [k for k in grads if sharded and is_expert(k)])):
        for dtype in sorted({grads[k].dtype for k in names}, key=str):
            kind = [k for k in names if grads[k].dtype == dtype]
            flat = torch.cat([grads[k].reshape(-1) for k in kind])
            dist.all_reduce(flat, group=mesh.group(axis))
            off = 0
            for k in kind:
                out[k] = flat[off:off + grads[k].numel()].view_as(grads[k])
                off += grads[k].numel()
    return out


def barrier(mesh: "Optional[Mesh]") -> None:
    """Wait for every rank of ``mesh`` (an ``all_reduce`` of one element,
    on the card under NCCL); nothing without process groups."""
    if mesh is None or mesh.world_group is None:
        return
    nccl = dist.get_backend(mesh.world_group) == "nccl"
    flag = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device())
                       if nccl else "cpu")
    dist.all_reduce(flag, group=mesh.world_group)
