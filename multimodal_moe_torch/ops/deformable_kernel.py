"""Multi-scale deformable attention forward: the CUDA kernel
``csrc/ms_deform_fwd.cu``, its wrapper and its launch count.

Port of ``multimodal_moe_tpu/ops/deformable_pallas.py:_fwd_kernel``. The
plain version is :func:`.deformable.ms_deformable_attention`. A CUDA tensor
launches the kernel; a CPU tensor takes the plain version. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .deformable import level_shapes_to_offsets, ms_deformable_attention

# Launches of the CUDA kernel in this process (the plain version does not count).
ms_deform_fwd_launches = 0

MAX_LEVELS = 8
MAX_HEAD_DIM = 32  # one channel per lane of a warp


def _lib():
    from .._build import load

    lib = load("ms_deform_fwd")
    lib.ms_deform_fwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    lib.ms_deform_fwd_launch.restype = ctypes.c_int
    return lib


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


def ms_deform_attn_fwd(
    values: torch.Tensor,
    level_shapes: "Sequence[Tuple[int, int]]",
    loc: torch.Tensor,
    attn: torch.Tensor,
) -> torch.Tensor:
    """values ``(B, ΣHW, NH, D)`` f32, loc ``(B, Q, NH, L, P, 2)`` f32,
    attn ``(B, Q, NH, L, P)`` f32 → ``(B, Q, NH·D)`` f32."""
    level_shapes = _check(values, level_shapes, loc, attn)
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
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.ms_deform_fwd_launch(
            values.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, total, q, nh, d, n_levels, n_points, hw, stream,
        )
    if err != 0:
        raise RuntimeError(f"ms_deform_fwd kernel launch failed: cudaError_t {err}")
    global ms_deform_fwd_launches
    ms_deform_fwd_launches += 1
    return out
