"""Greedy NMS keep mask: the CUDA kernel ``csrc/nms_keep.cu``, its wrapper,
its launch count and its plain PyTorch version.

Port of ``multimodal_moe_tpu/ops/nms_pallas.py:_nms_keep_kernel``. Over K
candidates sorted by descending score, a candidate that is valid and still
alive removes every later candidate whose IoU with it is >= the threshold
(and whose class is the same, unless ``class_agnostic``). The result is a
``(B, K)`` int32 keep mask, compacted to ``max_det`` outside.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
There is no fallback from one to the other: a failed build or launch
raises. The kernel is two launches at any pool K: :func:`ctas_per_image`
CTAs an image write the IoU bitmask into a scratch buffer (as many words an
image as the library's ``nms_scratch_words`` says, a 64-bit count), then
one CTA an image walks it (in shared memory up to K = 1024, in the scratch
above). :func:`pair_suppresses` is the kernel's per-pair decision rule (its
zero-overlap shortcut and margin filter included) in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .boxes import EPS, box_area, pairwise_iou

# Launches of the CUDA kernel in this process (the plain version does not count).
nms_keep_launches = 0

MAX_CTAS = 32    # CTAs an image for the mask


def _lib(defines: "tuple[str, ...]" = ()):
    """The kernel's library; ``defines`` load another build of the source
    (``("NMS_MARGIN_FILTER=0",)``: without the margin filter)."""
    from .._build import load

    lib = load("nms_keep", defines)
    lib.nms_scratch_words.argtypes = [ctypes.c_int]
    lib.nms_scratch_words.restype = ctypes.c_longlong
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nms_keep_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ctas_per_image(b: int, sm_count: int = 132) -> int:
    """CTAs that compute one image's mask: the least power of two, at most
    ``MAX_CTAS``, with which the ``b`` images' CTAs fill ``sm_count`` SMs
    twice."""
    c = 1
    while c < MAX_CTAS and b * c < 2 * sm_count:
        c *= 2
    return c


def filter_factors(iou_threshold: float):
    """The kernel's margin factors ``(c_lo, c_hi)`` for a threshold, float32
    tensors, NaN where the filter is off (t <= 0, or t outside
    [2**-90, 2**90], or NaN)."""
    t = torch.tensor(iou_threshold, dtype=torch.float32)
    on = bool(t > 0) and 2.0**-90 <= float(t) <= 2.0**90
    if not on:
        nan = torch.tensor(float("nan"), dtype=torch.float32)
        return nan, nan
    return (t * torch.tensor(1 - 2.0**-20, dtype=torch.float32),
            t * torch.tensor(1 + 2.0**-20, dtype=torch.float32))


def pair_suppresses(box_i, box_j, iou_threshold: float, same_class=None):
    """The kernel's decision for the pair (i, j) in plain PyTorch: whether
    row i's box removes column j's (``pairwise_iou >= iou_threshold``, with a
    different class counting as IoU 0). Boxes broadcast against each other.

    No division where the answer is already known: for t <= 0 a zero
    intersection counts unless ``area_i + area_j`` is NaN (its IoU is +0 or
    NaN); for t > 0 the margin filter settles every pair whose IoU lies
    clearly off the threshold, a zero intersection included. The rest divide
    in pairwise_iou's order."""
    t = torch.tensor(iou_threshold, dtype=torch.float32)
    lt = torch.maximum(box_i[..., 0:2], box_j[..., 0:2])
    rb = torch.minimum(box_i[..., 2:4], box_j[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_sum = box_area(box_i) + box_area(box_j)
    den = (area_sum - inter) + EPS
    divided = inter / den >= t
    zero_hits = bool(0.0 >= t)
    if zero_hits:
        bit = torch.where(inter == 0.0, ~torch.isnan(area_sum), divided)
    else:
        c_lo, c_hi = filter_factors(iou_threshold)
        sure = inter > c_hi * den
        bit = torch.where(sure | (inter < c_lo * den), sure, divided)
    if same_class is None:
        return bit
    return torch.where(same_class, bit, zero_hits)


def _nms_keep_mask_plain(boxes, valid, classes, *, iou_threshold, class_agnostic):
    """The same function in plain PyTorch: the Pallas kernel's serial sweep,
    with the batch as a vector dimension and the IoU matrix precomputed."""
    b, k, _ = boxes.shape
    iou = pairwise_iou(boxes, boxes)
    if not class_agnostic:
        iou = torch.where(classes[:, :, None] == classes[:, None, :], iou, 0.0)
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou >= iou_threshold) & later
    alive = valid.bool().clone()
    for i in range(k):
        alive &= ~(suppress[:, i, :] & alive[:, i:i + 1])
    return alive.to(torch.int32)


def nms_keep_mask(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_threshold: float,
    class_agnostic: bool,
) -> torch.Tensor:
    """boxes ``(B, K, 4)`` f32 score-sorted, valid ``(B, K)`` i32, classes
    ``(B, K)`` i32 → keep ``(B, K)`` i32."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    for name, t in (("valid", valid), ("classes", classes)):
        if tuple(t.shape) != (b, k):
            raise ValueError(f"{name} must be {(b, k)}, got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if boxes.device.type == "cpu":
        return _nms_keep_mask_plain(
            boxes, valid, classes,
            iou_threshold=iou_threshold, class_agnostic=class_agnostic,
        )
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous() and classes.is_contiguous()):
        raise ValueError("nms_keep_mask needs contiguous tensors")
    if b == 0 or k == 0:
        return torch.empty((b, k), dtype=torch.int32, device=boxes.device)
    keep = _launch(_lib(), boxes, valid, classes, iou_threshold, class_agnostic)
    global nms_keep_launches
    nms_keep_launches += 1
    return keep


def _launch(lib, boxes, valid, classes, iou_threshold, class_agnostic) -> torch.Tensor:
    """Launch ``lib``'s kernel on checked, non-empty CUDA tensors; raise on
    failure. The scratch is K²/8 bytes an image (20 MB at K = 18,018); where
    the card cannot hold it, ``torch.empty`` raises its out-of-memory error."""
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.int32, device=boxes.device)
    scratch = torch.empty(b * lib.nms_scratch_words(k), dtype=torch.int32,
                          device=boxes.device)
    ctas = ctas_per_image(b, _sm_count(boxes.get_device()))
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_keep_launch(
            boxes.data_ptr(), valid.data_ptr(), classes.data_ptr(), keep.data_ptr(),
            scratch.data_ptr(), b, k, float(iou_threshold), int(bool(class_agnostic)),
            ctas, stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError_t {err}")
    return keep
