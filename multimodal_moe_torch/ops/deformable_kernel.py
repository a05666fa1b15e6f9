"""Multi-scale deformable attention: the CUDA kernels ``csrc/ms_deform_fwd.cu``
and ``csrc/ms_deform_bwd.cu``, their wrappers and launch counts, and the
autograd function that joins them.

Port of ``multimodal_moe_tpu/ops/deformable_pallas.py`` (``_fwd_kernel``,
``_bwd_kernel`` with the elementwise part of ``_bwd_rule`` fused in, and the
``custom_vjp`` around them). The plain versions are
:func:`.deformable.ms_deformable_attention` and
:func:`.deformable.ms_deform_attn_bwd_plain` followed by
:func:`.deformable.ms_deform_attn_loc_attn_grads`. A CUDA tensor launches
the kernels; a CPU tensor takes the plain versions. There is no fallback
from one to the other. ``ms_deform_attn_fwd`` is differentiable on both.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .deformable import (
    _corners,
    _geometry,
    _inside,
    level_shapes_to_offsets,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_loc_attn_grads,
    ms_deformable_attention,
)

# Launches of the CUDA kernels in this process (the plain versions do not count).
ms_deform_fwd_launches = 0
ms_deform_bwd_launches = 0

MAX_LEVELS = 8
MAX_HEAD_DIM = 32  # a value row fits one warp
U32 = 2.0 ** -24   # float32 unit roundoff


def _lib(name: str):
    """``name`` is ``ms_deform_fwd`` (4 pointers) or ``ms_deform_bwd`` (7)."""
    from .._build import load

    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * (4 if name == "ms_deform_fwd" else 7) + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(values, level_shapes, loc, attn) -> "Tuple[Tuple[int, int], ...]":
    if values.dim() != 4:
        raise ValueError(f"values must be (B, ΣHW, NH, D), got {tuple(values.shape)}")
    b, total, nh, d = values.shape
    if attn.dim() != 5 or attn.shape[0] != b or attn.shape[2] != nh:
        raise ValueError(f"attn must be (B, Q, NH, L, P) = ({b}, Q, {nh}, L, P), "
                         f"got {tuple(attn.shape)}")
    if tuple(loc.shape) != tuple(attn.shape) + (2,):
        raise ValueError(f"loc must be {tuple(attn.shape) + (2,)}, got {tuple(loc.shape)}")
    level_shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    if len(level_shapes) != attn.shape[3]:
        raise ValueError(f"{len(level_shapes)} level shapes for L={attn.shape[3]}")
    if len(level_shapes) > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels, got {len(level_shapes)}")
    # The Pallas wrapper's limit, kept so that both accept the same inputs.
    for h_l, w_l in level_shapes:
        if h_l < 2 or w_l < 2:
            raise ValueError(
                f"deformable kernel requires every level >= 2x2, got {level_shapes}"
            )
    if level_shapes_to_offsets(level_shapes)[1] != total:
        raise ValueError(f"values axis {total} != Σ H_l·W_l of {level_shapes}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    for name, t in (("values", values), ("loc", loc), ("attn", attn)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on {values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return level_shapes


def _fwd(values, level_shapes, loc, attn) -> torch.Tensor:
    """Forward on checked inputs: the kernel on the card, the plain version
    on the CPU."""
    if values.device.type == "cpu":
        return ms_deformable_attention(values, level_shapes, loc, attn)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    b, total, nh, d = values.shape
    _, q, _, n_levels, n_points = attn.shape
    out = torch.empty((b, q, nh * d), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out
    hw = (ctypes.c_int * (2 * n_levels))(*[v for s in level_shapes for v in s])
    launch = _lib("ms_deform_fwd")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = launch(
            values.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, total, q, nh, d, n_levels, n_points, hw, stream,
        )
    if err != 0:
        raise RuntimeError(f"ms_deform_fwd kernel launch failed: cudaError_t {err}")
    global ms_deform_fwd_launches
    ms_deform_fwd_launches += 1
    return out


def ms_deform_attn_bwd(
    values: torch.Tensor,
    level_shapes: "Sequence[Tuple[int, int]]",
    loc: torch.Tensor,
    attn: torch.Tensor,
    g: torch.Tensor,
) -> "Tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The whole backward: the inputs of the forward and the output
    cotangent g ``(B, Q, NH·D)`` f32 → ``dv`` ``(B, ΣHW, NH, D)``, ``d_loc``
    ``(B, Q, NH, L, P, 2)`` and ``d_attn`` ``(B, Q, NH, L, P)``. One kernel
    launch on the card; on the CPU :func:`.deformable.ms_deform_attn_bwd_plain`
    followed by :func:`.deformable.ms_deform_attn_loc_attn_grads`."""
    level_shapes = _check(values, level_shapes, loc, attn)
    b, total, nh, d = values.shape
    _, q, _, n_levels, n_points = attn.shape
    if tuple(g.shape) != (b, q, nh * d):
        raise ValueError(f"g must be {(b, q, nh * d)}, got {tuple(g.shape)}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if g.device != values.device:
        raise ValueError(f"g is on {g.device}, values on {values.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if values.device.type == "cpu":
        dv, s = ms_deform_attn_bwd_plain(values, level_shapes, loc, attn, g)
        return (dv, *ms_deform_attn_loc_attn_grads(level_shapes, loc, attn, s))
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    dv = torch.zeros_like(values)
    d_loc = torch.empty_like(loc)
    d_attn = torch.empty_like(attn)
    if d_attn.numel() == 0:
        return dv, d_loc, d_attn
    hw = (ctypes.c_int * (2 * n_levels))(*[v for sh in level_shapes for v in sh])
    launch = _lib("ms_deform_bwd")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = launch(
            values.data_ptr(), loc.data_ptr(), attn.data_ptr(), g.data_ptr(), dv.data_ptr(),
            d_loc.data_ptr(), d_attn.data_ptr(), b, total, q, nh, d, n_levels, n_points, hw,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ms_deform_bwd kernel launch failed: cudaError_t {err}")
    global ms_deform_bwd_launches
    ms_deform_bwd_launches += 1
    return dv, d_loc, d_attn


def deform_bwd_tolerance(values, level_shapes, loc, attn, g):
    """Per-element bounds on ``|kernel − plain|`` for ``(dv, d_loc, d_attn)``,
    each ``2·n·u·Σ|terms|`` (u = 2⁻²⁴): two float32 evaluations of a sum of
    n rounded terms, each within ``n·u·Σ|terms|`` of the exact value.

    * ``dv``: the ``attn·bilinear·g`` contributions that land on each element
      (both sides round them alike), n their count on the value row.
    * ``d_attn = Σ_c w_c·⟨g, V_c⟩``: the terms ``w_c·g_d·V_cd``; n = D + 4
      (the dot's D roundings, the product with ``w_c``, the 3 additions).
    * ``d_loc``: ``W_l·Σ_c attn·wy_c·g_d·V_cd`` for x (``wx_c`` and ``H_l``
      for y); n = D + 6 (the dot, the products with ``attn`` and ``wy_c``, the
      3 additions, the scale by ``W_l``).

    The bilinear weights are the float32 ones both sides compute alike. A
    point whose corners all lie outside the map gets a bound of 0: both
    sides must give exactly 0 there."""
    level_shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    b, total, nh, d = values.shape
    dv_abs, s_abs = ms_deform_attn_bwd_plain(values.abs(), level_shapes, loc, attn.abs(), g.abs())
    counts = torch.zeros(b * total * nh, device=values.device)
    batch = torch.arange(b, device=values.device).view(b, 1, 1, 1, 1)
    head = torch.arange(nh, device=values.device).view(1, 1, nh, 1, 1)
    for _, _, _, inside, flat_idx in _corners(level_shapes, loc):
        rows = ((batch * total + flat_idx) * nh + head)[inside]
        counts.index_add_(0, rows, torch.ones(rows.shape, device=values.device))
    h_l, w_l, x0, y0, wx, wy = _geometry(level_shapes, loc)
    a = attn.abs()
    t_attn, t_x, t_y = (torch.zeros_like(wx) for _ in range(3))
    for c, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        inside = _inside(x0 + dx, y0 + dy, w_l, h_l)
        s_c = s_abs[..., c]
        wx_c = wx if dx else 1.0 - wx
        wy_c = wy if dy else 1.0 - wy
        t_attn = t_attn + torch.where(inside, wy_c * wx_c * s_c, 0.0)
        t_x = t_x + torch.where(inside, s_c * a * wy_c, 0.0)
        t_y = t_y + torch.where(inside, s_c * a * wx_c, 0.0)
    dv_tol = 2 * counts.view(b, total, nh, 1) * U32 * dv_abs
    d_loc_tol = 2 * (d + 6) * U32 * torch.stack([t_x * w_l, t_y * h_l], dim=-1)
    return dv_tol, d_loc_tol, 2 * (d + 4) * U32 * t_attn


class _MSDeformAttn(torch.autograd.Function):
    """Forward kernel (B4) and backward kernel (B5) as one differentiable op,
    the counterpart of ``ms_deformable_attention_pallas``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, values, loc, attn, level_shapes):
        ctx.level_shapes = level_shapes
        ctx.save_for_backward(values, loc, attn)
        return _fwd(values, level_shapes, loc, attn)

    @staticmethod
    def backward(ctx, g):
        values, loc, attn = ctx.saved_tensors
        return (*ms_deform_attn_bwd(values, ctx.level_shapes, loc, attn, g.contiguous()), None)


def ms_deform_attn_fwd(
    values: torch.Tensor,
    level_shapes: "Sequence[Tuple[int, int]]",
    loc: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """values ``(B, ΣHW, NH, D)`` f32, loc ``(B, Q, NH, L, P, 2)`` f32,
    attn ``(B, Q, NH, L, P)`` f32 → ``(B, Q, NH·D)`` f32. Differentiable in
    all three: the backward runs :func:`ms_deform_attn_bwd`."""
    level_shapes = _check(values, level_shapes, loc, attn)
    return _MSDeformAttn.apply(values, loc, attn, level_shapes)
