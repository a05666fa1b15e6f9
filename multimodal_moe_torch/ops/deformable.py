"""Multi-scale deformable attention sampling, plain PyTorch.

Counterpart of ``multimodal_moe_tpu/ops/deformable.py``: bilinear
interpolation as four flat gathers and a weighted sum, over one
``(B, ΣHW, NH, D)`` value tensor in which every level's map is flattened
row-major and the levels are concatenated. This is the plain version of the
CUDA kernel in :mod:`.deformable_kernel`; the CPU takes it.
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
    the map contributes zero."""
    b, total, n_heads, head_dim = values.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    offsets, expected = level_shapes_to_offsets(level_shapes)
    if expected != total:
        raise ValueError(f"values axis {total} != Σ level sizes {expected}")
    dev = values.device
    hw = torch.tensor([[h, w] for h, w in level_shapes], dtype=torch.float32, device=dev)
    h_l = hw[:, 0][None, None, None, :, None]                  # (1,1,1,L,1)
    w_l = hw[:, 1][None, None, None, :, None]
    w_int = hw[:, 1].long()[None, None, None, :, None]
    start = torch.tensor(offsets, dtype=torch.long, device=dev)[None, None, None, :, None]

    x = sampling_locations[..., 0] * w_l - 0.5                 # (B,Q,NH,L,P)
    y = sampling_locations[..., 1] * h_l - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    values_t = values.permute(0, 2, 1, 3)                      # (B,NH,ΣHW,D)
    out = torch.zeros((b, n_heads, q, head_dim), dtype=values.dtype, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            cx = x0 + dx
            cy = y0 + dy
            weight = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
            in_bounds = (cx >= 0) & (cx < w_l) & (cy >= 0) & (cy < h_l)
            cxc = torch.minimum(torch.clamp(cx, min=0), w_l - 1).long()
            cyc = torch.minimum(torch.clamp(cy, min=0), h_l - 1).long()
            flat_idx = start + cyc * w_int + cxc                # (B,Q,NH,L,P)
            w_eff = (weight * in_bounds * attention_weights).to(values.dtype)

            idx = flat_idx.permute(0, 2, 1, 3, 4).reshape(b, n_heads, -1)  # (B,NH,QLP)
            vals = torch.gather(values_t, 2, idx[..., None].expand(-1, -1, -1, head_dim))
            vals = vals.reshape(b, n_heads, q, n_levels * n_points, head_dim)
            w_r = w_eff.permute(0, 2, 1, 3, 4).reshape(b, n_heads, q, n_levels * n_points, 1)
            out = out + (vals * w_r).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, q, n_heads * head_dim)
