"""The least time of the multi-scale deformable attention's kernels, B4
(forward, ``csrc/ms_deform_fwd.cu``) and B5 (backward,
``csrc/ms_deform_bwd.cu``), on one H100, from a call's shapes (the counts
of the port's ``rtdetr.deform`` span) and from its sampling locations.

The arithmetic is ``chip_smoke.py``'s ``deform_bound`` and
``deform_bwd_bound``: the bytes are every value row (one head's D floats)
that an in-bounds corner with a non-zero weight samples, read once, the
locations and weights read once and the output written once (the backward
adds ``dv``, the size of the values, and three floats a point written);
the operations are each such corner's multiply-adds (2·D forward, 4·D
backward) and each point's geometry (and the backward's elementwise part)
at the fp32 rate. The bound is the longer of the two. It counts the same
work whatever implements the kernels.
"""

from __future__ import annotations

import torch

from .common import PEAK_BYTES_PER_S, PEAK_FLOPS

POINT_FLOPS = 20                 # a point's geometry (chip_smoke.DEFORM_POINT_FLOPS)
BWD_EPILOGUE_FLOPS = 4 * 10 + 2  # the backward's elementwise part a point
PEAK_FP32 = PEAK_FLOPS["fp32"]   # multiply-add counted as two operations

FWD_KERNEL = "ms_deform_fwd_kernel"
BWD_KERNEL = "ms_deform_bwd_kernel"


def is_fwd_kernel(name: str) -> bool:
    """Whether a device operation is B4's launch, demangled or mangled."""
    return FWD_KERNEL in (name or "")


def is_bwd_kernel(name: str) -> bool:
    return BWD_KERNEL in (name or "")


def sampled_work(loc: torch.Tensor, attn: torch.Tensor, level_shapes,
                 value_rows: int) -> "tuple[int, int]":
    """(distinct value rows sampled, corners sampled) of one call: loc
    ``(B, Q, NH, L, P, 2)`` and attn ``(B, Q, NH, L, P)`` in float32, the
    kernel's geometry (``x = loc·W − 0.5``, the four corners around it);
    a row is ``(image, pixel, head)``, a corner counts where it lies in the
    map and its weight is not zero."""
    b, _, nh, n_levels, _, _ = loc.shape
    dev = loc.device
    hw = torch.tensor(level_shapes, dtype=torch.float32, device=dev).view(1, 1, 1, n_levels, 1, 2)
    hgt, wid = hw[..., 0], hw[..., 1]
    sizes = [int(h) * int(w) for h, w in level_shapes]
    starts = torch.tensor([sum(sizes[:i]) for i in range(n_levels)], device=dev)
    starts = starts.view(1, 1, 1, n_levels, 1)
    x = loc[..., 0] * wid - 0.5
    y = loc[..., 1] * hgt - 0.5
    x0, y0 = x.floor(), y.floor()
    wx, wy = x - x0, y - y0
    batch = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    head = torch.arange(nh, device=dev).view(1, 1, nh, 1, 1)
    rows, corners = [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            w = attn * (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            ok = (cx >= 0) & (cx < wid) & (cy >= 0) & (cy < hgt) & (w != 0)
            pix = (starts + torch.where(ok, cy, 0).long() * wid.long()
                   + torch.where(ok, cx, 0).long())
            rows.append(((batch * value_rows + pix) * nh + head)[ok])
            corners += int(ok.sum())
    return int(torch.unique(torch.cat(rows)).numel()), corners


def _sizes(counts: dict, head_dim: int) -> dict:
    b, q, nh = counts["batch"], counts["queries"], counts["heads"]
    points = b * q * nh * counts["levels"] * counts["points"]
    return {"points": points, "loc": 2 * points, "out": b * q * nh * head_dim,
            "values": b * counts["value_rows"] * nh * head_dim}


def fwd_bound(counts: dict, head_dim: int, rows: int, corners: int) -> "tuple[float, str]":
    """Least seconds of one B4 call: ``counts`` of its ``rtdetr.deform``
    span, ``rows`` and ``corners`` of :func:`sampled_work`."""
    n = _sizes(counts, head_dim)
    nbytes = 4 * (rows * head_dim + n["loc"] + n["points"] + n["out"])
    flops = corners * 2 * head_dim + n["points"] * POINT_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bwd_bound(counts: dict, head_dim: int, rows: int, corners: int) -> "tuple[float, str]":
    """Least seconds of one B5 call: the forward's reads (with ``g`` in the
    output's place), ``dv`` and ``d_loc``, ``d_attn`` (3 floats a point)
    written; each corner's dot and add (4·D) and each point's geometry and
    elementwise part."""
    n = _sizes(counts, head_dim)
    nbytes = 4 * (rows * head_dim + n["loc"] + n["points"] + n["out"]
                  + 3 * n["points"] + n["values"])
    flops = corners * 4 * head_dim + n["points"] * (POINT_FLOPS + BWD_EPILOGUE_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(run, kind: str, bound, is_kernel) -> "float | None":
    """100 × Σ bound over the profiled stretch's calls / the device time of
    the kernel's launches there, or None where the run holds nothing: the
    calls' shapes from the ``rtdetr.deform`` spans, their sampled work from
    ``run.layer["deform_work"]`` (one entry a call, in the same order)."""
    from . import spans

    lay = run.layer
    if lay.get("kind") != kind or not lay.get("events") or not lay.get("deform_work"):
        return None
    found = [s["counts"] for s in spans.log(run, kind) if s["name"] == "rtdetr.deform"]
    work = lay["deform_work"]
    if not found or len(found) != len(work):
        return None
    kernel_us = sum(e - s for n, s, e in lay["events"] if is_kernel(n))
    if kernel_us <= 0:
        return None
    head_dim = run.config["hidden_dim"] // run.config["num_heads"]
    bound_s = sum(bound(c, head_dim, rows, corners)[0] for c, (rows, corners) in zip(found, work))
    return 100.0 * bound_s * 1e6 / kernel_us
