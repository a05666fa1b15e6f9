"""Operations and bytes of the kernels whose share of the roofline the
benchmark reports, computed from shapes and from the step's own inputs,
and the least time each needs on one H100.

``nms_bound`` is the arithmetic of ``chip_smoke.py:nms_bound`` (B1's keep
mask), ``moe_routed_bound`` that of the routed work of the MoE levels.
"""

from __future__ import annotations

import re

import torch

from .common import PEAK_BYTES_PER_S, PEAK_FLOPS
from .reference.detector import STRIDES, widths

IOU_FLOPS = 14                      # min/max/sub/mul/add/div/compare a pair
PEAK_FP32_OPS = PEAK_FLOPS["fp32"] / 2   # single fp32 operations (no multiply-add)

# The keep mask's launches (csrc/nms_keep.cu): the mask, then the walk.
NMS_KERNELS = ("mask_kernel", "mask_tiles_kernel", "walk_kernel", "walk_global_kernel")


_NAMES = "|".join(NMS_KERNELS)
_NMS_NAME = re.compile(r"^(?:(?:void )?(?:\(anonymous namespace\)::)?(?:%s)[<(]"
                       r"|_Z\w*?\d+(?:%s)I?E?)" % (_NAMES, _NAMES))


def is_nms_kernel(name: str) -> bool:
    """Whether a device operation's name is one of B1's launches, as the
    profiler names it: demangled (``void (anonymous namespace)::mask_kernel<
    false, true>(…)``) or mangled (``_ZN12_GLOBAL__N_111mask_kernelILb0E…``)."""
    return bool(_NMS_NAME.match(name or ""))


def nms_bound(valid_counts: torch.Tensor, k: int) -> "tuple[float, str]":
    """Least seconds for the keep mask of one batch with ``valid_counts[b]``
    valid candidates of ``k`` an image, single class: every input byte read
    once and the mask written once, or for each pair j > i of valid
    candidates the IoU's 14 single fp32 operations at half the fp32 peak,
    whichever is longer. The greedy walk's serial chain is not in it."""
    n = valid_counts.double()
    pairs = float((n * (n - 1) / 2).sum())
    b = n.numel()
    nbytes = b * k * (16 + 4 + 4) + b * k * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = pairs * IOU_FLOPS / PEAK_FP32_OPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def moe_routed_bound(cfg: dict, batch: int, img_h: int, img_w: int, *, peak_flops: float,
                     act_bytes: int, weight_bytes: int) -> "tuple[float, str]":
    """Least seconds for the routed work of the MoE levels of one step: the
    routed FLOPs (T·k tokens through d → h → d, plus the router's T·d·E) at
    ``peak_flops``, or the bytes (every token read once and written once,
    every expert weight and the router read once) at the bandwidth,
    whichever is longer. The same work whatever route implements it."""
    e, k = cfg["num_experts"], cfg["top_k"]
    flops = nbytes = 0.0
    for s, d in zip(STRIDES, widths(cfg)[2:5]):
        t = batch * (img_h // s) * (img_w // s)
        hid = int(d * cfg["moe_hidden_mult"])
        flops += t * k * 2.0 * (2 * d * hid) + 2.0 * t * d * e
        nbytes += 2.0 * t * d * act_bytes + e * (2 * d * hid + hid + d) * weight_bytes \
            + (d * e + cfg["num_context_bins"] * e) * 4
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
