"""Multi-scale deformable attention sampling, plain PyTorch.

Counterpart of ``multimodal_moe_tpu/ops/deformable.py``: bilinear
interpolation as four flat gathers and a weighted sum, over one
``(B, ΣHW, NH, D)`` value tensor in which every level's map is flattened
row-major and the levels are concatenated. ``ms_deformable_attention`` and
``ms_deform_attn_bwd_plain`` followed by ``ms_deform_attn_loc_attn_grads``
are the plain versions of the CUDA kernels in :mod:`.deformable_kernel`
(forward and fused backward); the CPU takes them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def level_shapes_to_offsets(shapes: "Sequence[Tuple[int, int]]") -> "Tuple[list, int]":
    """[(H_l, W_l)] → (per-level start offsets into the flattened ΣHW axis,
    ΣHW)."""
    sizes = [int(h) * int(w) for h, w in shapes]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    return offsets, sum(sizes)


def ms_deformable_attention(
    values: torch.Tensor,             # (B, ΣHW, NH, D)
    level_shapes: "Sequence[Tuple[int, int]]",
    sampling_locations: torch.Tensor,  # (B, Q, NH, L, P, 2) in [0, 1]
    attention_weights: torch.Tensor,   # (B, Q, NH, L, P), softmaxed
) -> torch.Tensor:
    """→ (B, Q, NH·D). ``grid_sample`` semantics with align_corners=False and
    zero padding: location x maps to pixel ``x·W − 0.5``; a corner outside
    the map (every corner of a NaN or ±inf location too) contributes
    nothing: it is selected out, never multiplied by a zero weight."""
    b, total, n_heads, head_dim = values.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    _check_total(level_shapes, total)
    values_t = values.permute(0, 2, 1, 3)                      # (B,NH,ΣHW,D)
    out = torch.zeros((b, n_heads, q, head_dim), dtype=values.dtype, device=values.device)
    per_query = lambda t: t.permute(0, 2, 1, 3, 4).reshape(  # noqa: E731
        b, n_heads, q, n_levels * n_points, 1)
    for _, _, weight, in_bounds, flat_idx in _corners(level_shapes, sampling_locations):
        w_eff = (weight * attention_weights).to(values.dtype)
        idx = flat_idx.permute(0, 2, 1, 3, 4).reshape(b, n_heads, -1)  # (B,NH,QLP)
        vals = torch.gather(values_t, 2, idx[..., None].expand(-1, -1, -1, head_dim))
        vals = vals.reshape(b, n_heads, q, n_levels * n_points, head_dim)
        out = out + torch.where(per_query(in_bounds), vals * per_query(w_eff), 0.0).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, q, n_heads * head_dim)


def _check_total(level_shapes, total: int) -> None:
    expected = level_shapes_to_offsets(level_shapes)[1]
    if expected != total:
        raise ValueError(f"values axis {total} != Σ level sizes {expected}")


def _geometry(level_shapes, loc: torch.Tensor):
    """Pixel coordinates of the sample points: the level sizes broadcast to
    ``(1,1,1,L,1)``, the corner ``(x0, y0)`` and the fractions ``(wx, wy)``,
    each ``(B,Q,NH,L,P)``; ``x = loc_x·W − 0.5`` in float32."""
    hw = torch.tensor([[h, w] for h, w in level_shapes], dtype=torch.float32, device=loc.device)
    h_l = hw[:, 0][None, None, None, :, None]                  # (1,1,1,L,1)
    w_l = hw[:, 1][None, None, None, :, None]
    x = loc[..., 0] * w_l - 0.5                                # (B,Q,NH,L,P)
    y = loc[..., 1] * h_l - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return h_l, w_l, x0, y0, x - x0, y - y0


def _corners(level_shapes, loc: torch.Tensor):
    """For each bilinear corner ``(dy, dx)`` in the order of ``c = 2·dy + dx``:
    ``(dy, dx, weight, in_bounds, flat_idx)``, each ``(B,Q,NH,L,P)``. A corner
    outside the map, which includes every corner of a NaN or ±inf location,
    has ``in_bounds`` False and its level's first row as index: coordinates
    are selected before the cast to an integer."""
    h_l, w_l, x0, y0, wx, wy = _geometry(level_shapes, loc)
    offsets, _ = level_shapes_to_offsets(level_shapes)
    w_int = w_l.long()
    start = torch.tensor(offsets, dtype=torch.long, device=loc.device)[None, None, None, :, None]
    for dy in (0, 1):
        for dx in (0, 1):
            cx = x0 + dx
            cy = y0 + dy
            weight = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
            in_bounds = _inside(cx, cy, w_l, h_l)
            cxc = torch.where(in_bounds, cx, 0.0).long()
            cyc = torch.where(in_bounds, cy, 0.0).long()
            yield dy, dx, weight, in_bounds, start + cyc * w_int + cxc


def _inside(cx, cy, w_l, h_l) -> torch.Tensor:
    """Whether corner ``(cx, cy)`` lies in the map; False for NaN too."""
    return (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)


def ms_deform_attn_bwd_plain(
    values: torch.Tensor,             # (B, ΣHW, NH, D) f32
    level_shapes: "Sequence[Tuple[int, int]]",
    loc: torch.Tensor,                # (B, Q, NH, L, P, 2) f32
    attn: torch.Tensor,               # (B, Q, NH, L, P) f32
    g: torch.Tensor,                  # (B, Q, NH·D) f32, the output's cotangent
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """The backward's gather-scatter part, in float32: ``dv`` ``(B, ΣHW, NH,
    D)`` (each corner in bounds adds ``attn·bilinear·g`` into its value row,
    with ``index_add_``) and the per-corner sums ``s`` ``(B, Q, NH, L, P, 4)``
    (``⟨g, V_c⟩`` for a corner in bounds, 0 for one outside). A corner
    outside adds exactly nothing, whatever its location."""
    b, total, nh, d = values.shape
    _check_total(level_shapes, total)
    g5 = g.reshape(b, -1, nh, 1, 1, d)
    rows_of = (torch.arange(b, device=values.device).view(b, 1, 1, 1, 1) * total,
               torch.arange(nh, device=values.device).view(1, 1, nh, 1, 1))
    flat_values = values.reshape(-1, d)
    dv = torch.zeros_like(flat_values)
    s = []
    for _, _, weight, in_bounds, flat_idx in _corners(level_shapes, loc):
        rows = (rows_of[0] + flat_idx) * nh + rows_of[1]      # (B,Q,NH,L,P) into (B·ΣHW·NH, D)
        vals = flat_values[rows]                              # (B,Q,NH,L,P,D)
        s.append(torch.where(in_bounds, (vals * g5).sum(-1), 0.0))
        add = torch.where(in_bounds[..., None], (weight * attn)[..., None] * g5, 0.0)
        dv.index_add_(0, rows.reshape(-1), add.reshape(-1, d))
    return dv.view(b, total, nh, d), torch.stack(s, dim=-1)


def ms_deform_attn_loc_attn_grads(
    level_shapes: "Sequence[Tuple[int, int]]",
    loc: torch.Tensor,                # (B, Q, NH, L, P, 2)
    attn: torch.Tensor,               # (B, Q, NH, L, P)
    s: torch.Tensor,                  # (B, Q, NH, L, P, 4), 0 for corners outside
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """``(d_loc, d_attn)`` from the per-corner sums, elementwise (the part of
    ``deformable_pallas._bwd_rule`` outside its kernel): ``d_attn = Σ_c
    bilinear_c·s_c``; a corner's weight moves by ∓ the other axis' weight as
    ``wx`` or ``wy`` grows (``slot_dw``), and ``d loc_x = W_l·d wx``. A corner
    outside the map adds nothing, so a point whose location is NaN or ±inf
    gets ``d_loc = 0`` and ``d_attn = 0``, as JAX's Pallas path gives."""
    h_l, w_l, x0, y0, wx, wy = _geometry(level_shapes, loc)
    d_attn = torch.zeros_like(wx)
    dwx = torch.zeros_like(wx)
    dwy = torch.zeros_like(wx)
    for c, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        inside = _inside(x0 + dx, y0 + dy, w_l, h_l)
        s_c = s[..., c]
        wx_c = wx if dx else 1.0 - wx
        wy_c = wy if dy else 1.0 - wy
        d_attn = d_attn + torch.where(inside, wy_c * wx_c * s_c, 0.0)
        dwx = dwx + torch.where(inside, s_c * attn * (wy_c * (1.0 if dx else -1.0)), 0.0)
        dwy = dwy + torch.where(inside, s_c * attn * ((1.0 if dy else -1.0) * wx_c), 0.0)
    return torch.stack([dwx * w_l, dwy * h_l], dim=-1), d_attn
